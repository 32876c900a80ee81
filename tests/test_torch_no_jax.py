"""The port stands alone: it never imports JAX, and importing it (and
solving with LSQR, CG or LSMR, taking a stored-adjoint isotropic, VTI, TTI,
constant-Q or IsoDenQ wave gradient, modelling with off-grid acquisition,
solving BASELINE config 3 with CGLS and config 1's operator with GMRES,
importing every module of the symmetric spaces and the operator packs, and
inverting the DSP chain and the blending model with LSQR, hashing,
checkpointing, compressing and streaming through ``jets_tpu_torch.utils``
(whose native libraries build with g++), importing every module of
``jets_tpu_torch.parallel`` and solving with LSQR on one-rank gloo 1-D and
block × grid meshes,
on the CPU, with
``jax``, ``jaxlib`` and ``jets_tpu`` blocked from import) needs neither
nvcc nor triton nor a built kernel library."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "jets_tpu_torch"

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "jets_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import torch
import jets_tpu_torch as tt
from jets_tpu_torch import kernels
from jets_tpu_torch.models import make_seismic_problem
from jets_tpu_torch.solvers import lsqr

A, m, d = make_seismic_problem((8, 8, 16), 2, 8, seed=0, noise=0.05, device="cpu")
res = lsqr(A, d, maxiter=5, tol=0.0)
assert res.iterations == 5 and bool(torch.isfinite(res.history).all())
import importlib
for mod in ("runner", "sharded", "collectives", "hetero", "gspmd"):
    importlib.import_module("jets_tpu_torch.parallel." + mod)
from jets_tpu_torch.parallel.sharded import make_block_mesh
mesh = make_block_mesh(device="cpu")  # one gloo rank
Am, _, dm = make_seismic_problem((8, 8, 16), 2, 8, seed=0, noise=0.05, mesh=mesh)
rm = lsqr(Am, dm, maxiter=5, tol=0.0)
assert mesh.backend == "gloo" and torch.equal(rm.x, res.x)
from jets_tpu_torch.parallel.gspmd import make_mesh_2d
mesh2 = make_mesh_2d(1, 1, device="cpu")  # the block x grid mesh of the same world
A2, _, d2 = make_seismic_problem((8, 8, 16), 2, 8, seed=0, noise=0.05, mesh=mesh2)
assert torch.equal(lsqr(A2, d2, maxiter=5, tol=0.0).x, res.x)
g = torch.Generator().manual_seed(0)
lhs, rhs = tt.dot_product_test(A, A.dom.randn(g), A.rng.randn(g))
assert abs(float(lhs) - float(rhs)) <= 1e-4 * abs(float(rhs))
from jets_tpu_torch.ops.wave import wave_propagator
F = wave_propagator((6, 8, 16), nt=12, dt=6e-4, src_idx=3 * 128 + 4 * 16 + 8,
                    sponge_width=2, store_adjoint="int8", fused=True, device="cpu")
c = torch.full((6, 8, 16), 1500.0)
g = F.linearize(c).H(F(c * 1.02) - F(c))
assert g.shape == (6, 8, 16) and bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
Fv = tt.vti_wave_propagator((6, 8, 16), nt=12, dt=6e-4, src_idx=3 * 128 + 4 * 16 + 8,
                            sponge_width=2, store_adjoint="int8", fused=True,
                            device="cpu")
m = tt.BlockVector((c, torch.full_like(c, 0.1), torch.full_like(c, 0.05)), Fv.dom)
gv = Fv.linearize(m).H(Fv(m * 1.02) - Fv(m))
assert isinstance(gv, tt.BlockVector) and gv.nblocks == 3
assert all(bool(torch.isfinite(b).all()) and bool(b.abs().max() > 0) for b in gv)
Ft = tt.tti_wave_propagator((6, 8, 16), nt=12, dt=6e-4, src_idx=3 * 128 + 4 * 16 + 8,
                            sponge_width=2, store_adjoint="int8", fused=True,
                            coeff_dtype=torch.bfloat16, device="cpu")
mt = tt.BlockVector((c, torch.full_like(c, 0.1), torch.full_like(c, 0.05),
                     torch.full_like(c, 0.3), torch.full_like(c, 0.7)), Ft.dom)
gt = Ft.linearize(mt).H(Ft(mt * 1.02) - Ft(mt))
assert isinstance(gt, tt.BlockVector) and gt.nblocks == 5
assert all(bool(torch.isfinite(b).all()) and bool(b.abs().max() > 0) for b in gt)
from jets_tpu_torch.solvers import cg, lsmr, normal_operator
rc = cg(normal_operator(A, 0.1), A.H(d), maxiter=5, tol=0.0)
rl = lsmr(A, d, maxiter=5, tol=0.0)
assert rc.iterations == rl.iterations == 5
assert bool(torch.isfinite(rc.history).all()) and bool(torch.isfinite(rl.history).all())
Fq = tt.q_wave_propagator((6, 8, 16), nt=12, dt=6e-4, src_idx=3 * 128 + 4 * 16 + 8,
                          sponge_width=2, store_adjoint="int8", fused=True,
                          coeff_dtype=torch.bfloat16, device="cpu")
mq = tt.BlockVector((c, torch.full_like(c, 40.0)), Fq.dom)
gq = Fq.linearize(mq).H(Fq(mq * 1.02) - Fq(mq))
assert isinstance(gq, tt.BlockVector) and gq.nblocks == 2
assert all(bool(torch.isfinite(b).all()) and bool(b.abs().max() > 0) for b in gq)
from jets_tpu_torch.models import configs
from jets_tpu_torch.solvers import gmres
res, rel, A3 = configs.run_config(configs.config3_deblur_cgls, maxiter=20, tol=0.0,
                                  side=32, device="cpu")
assert res.iterations == 20 and rel < 0.1 and bool(torch.isfinite(res.history).all())
Ag = configs.config1_spd_cg(n=24, device="cpu")[0]
xg = torch.ones(24, dtype=torch.float64)
rg = gmres(Ag, Ag(xg), maxiter=24, restart=8, tol=1e-12)
assert float(torch.linalg.vector_norm(rg.x - xg)) < 1e-8
from jets_tpu_torch.ops import cpml_wave_propagator
from jets_tpu_torch.ops.wave import multishot_wave_operator
from jets_tpu_torch.solvers import gauss_newton, lbfgs, least_squares_objective, nlcg
Fw = multishot_wave_operator((6, 8, 16), [3 * 32 + 4 * 8 + 4] * 2, nt=8, dt=6e-4,
                             sponge_width=1, window_shape=(6, 4, 8),
                             window_corners=[[0, 0, 0], [0, 4, 8]], store_adjoint="int8",
                             shot_map="map", remat_blocks=2, device="cpu")
fg = least_squares_objective(Fw, Fw(c * 1.02))
rb = lbfgs(fg, c, maxiter=2, mem=3, tol=0.0, bounds=(1400.0, 1700.0))
assert bool(torch.isfinite(rb.history).all()) and float(rb.phi) < float(fg(c)[0])
rn = nlcg(fg, c, maxiter=1, tol=0.0)
assert rn.iterations == 1 and float(rn.phi) < float(fg(c)[0])
Fg = multishot_wave_operator((12, 16), [6 * 16 + 4, 6 * 16 + 12], nt=16, sponge_width=2,
                             shot_map="map", dtype=torch.float64, device="cpu")
cg0 = torch.full((12, 16), 1500.0, dtype=torch.float64)
rgn = gauss_newton(Fg, Fg(cg0 * 1.02), cg0, outer_iters=1, inner_iters=2)
assert rgn.residuals[-1] < rgn.residuals[0]
Fc = cpml_wave_propagator((8, 8), nt=8, src_idx=36, pml_width=2, remat_blocks=2,
                          device="cpu")
c2 = torch.full((8, 8), 1500.0)
assert Fc.linearize(c2).H(Fc(c2)).shape == (8, 8)
import numpy as np
from jets_tpu_torch.ops import offgrid_wave_propagator, vdq_wave_propagator
Fd = vdq_wave_propagator((6, 8, 16), nt=12, dt=6e-4, src_idx=3 * 128 + 4 * 16 + 8,
                         sponge_width=2, store_adjoint="int8", device="cpu")
md = tt.BlockVector((c, torch.full_like(c, 1e-3), torch.full_like(c, 40.0)), Fd.dom)
gd = Fd.linearize(md).H(Fd(md * 1.02) - Fd(md))
assert isinstance(gd, tt.BlockVector) and gd.nblocks == 3
assert all(bool(torch.isfinite(b).all()) and bool(b.abs().max() > 0) for b in gd)
Fo = offgrid_wave_propagator((6, 8, 16), src_pos=(3.3, 4.2, 8.5), rcv_depth=2.5,
                             rcv_coords=(np.array([2.5, 5.0]), np.array([4.25, 8.0, 11.5])),
                             nt=12, dt=6e-4, sponge_width=2, device="cpu")
do = Fo(c)
assert do.shape == (12, 2, 3) and bool(torch.isfinite(do).all()) and bool(do.abs().max() > 0)
import importlib
for mod in ("core.spaces", "ops.fft", "ops.transforms", "ops.dsp", "ops.causal",
            "ops.wavelet", "ops.radon", "ops.interp", "ops.acquisition", "ops.elementwise"):
    importlib.import_module("jets_tpu_torch." + mod)
from jets_tpu_torch.ops import (bandpass_operator, blend_operator, integration_operator,
                                rfft_operator, shift_operator, taper_operator)
sp = tt.Space((4, 64), device="cpu")
Ad = shift_operator(sp, 3.5 * 0.004, dt=0.004) @ bandpass_operator(sp, 0.004, 8.0, 45.0,
                                                                   f_taper=4.0) @ taper_operator(
    sp, (0, 8))
dd = Ad(sp.ones())
rd = lsqr(Ad, dd, maxiter=5, tol=0.0)
assert rd.iterations == 5 and bool(torch.isfinite(rd.x).all())
R = rfft_operator(sp)
assert isinstance(R.rng, tt.SymmetricSpace) and R.H(R(sp.ones())).shape == (4, 64)
Bl = blend_operator(4, 16, [0, 5, 20, 30], 46, device="cpu") @ integration_operator(
    tt.Space((4, 16), device="cpu"))
assert lsqr(Bl, Bl(torch.ones(4, 16)), maxiter=3, tol=0.0).iterations == 3
import tempfile
from jets_tpu_torch import utils
tmp = tempfile.mkdtemp()
st = lsqr(A, d, maxiter=3, tol=0.0).state
h = utils.save_checkpoint(tmp + "/st.npz", st)
st2, meta = utils.load_checkpoint(tmp + "/st.npz", like=st)
assert h == meta["crc32c"] == utils.tree_hash(st2) and utils.crc32c(b"123456789") == 0xE3069283
store = utils.SnapshotStore((6, 8, 16), bits=12, path=tmp + "/snaps.bin")
store.append(c)
store.close()
assert float(abs(utils.SnapshotStore.open(tmp + "/snaps.bin").read(0) - 1500.0).max()) < 1.0
sg = utils.ShotGatherStore.create(tmp + "/shots.bin", torch.arange(32.0).reshape(4, 8))
blocks = [b for _, b in utils.ShotGatherLoader(sg, batch_shots=2, device_put=True,
                                                device="cpu")]
assert torch.equal(torch.cat(blocks), torch.arange(32.0).reshape(4, 8))
ma = A.dom.ones()
assert torch.equal(utils.checked(A, "A")(ma), A(ma))
assert kernels._libs == {}, "the CPU path loaded a kernel library"
bad = sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
print("OK")
"""


def test_port_imports_no_jax_and_needs_no_nvcc():
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH", "PYTHONPATH")}
    env["PATH"] = os.pathsep.join(p for p in ("/usr/bin", "/bin")
                                  if os.path.isdir(p))
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_module_of_the_port_names_jax_and_the_kernels_ship():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jets_tpu)(\s|\.|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders
    for name, entries in (
            ("solver_kernels.cu", ("jt_xw_update", "jt_laplacian3d",
                                   "jt_lap3d_axpy_norm2", "jt_cg_update", "jt_p_update",
                                   "jt_lsmr_update")),
            ("wave_kernels.cu", ("jt_leapfrog_step", "jt_adjoint_step", "jt_q_step")),
            ("vti_kernels.cu", ("jt_vti_step", "jt_vti_hist_step",
                                "jt_vti_adjoint_step")),
            ("tti_kernels.cu", ("jt_tti_step", "jt_tti_hist_step",
                                "jt_tti_adjoint_step"))):
        src = PKG / "csrc" / name
        assert src.is_file()
        text = src.read_text()
        for entry in entries:
            assert f"int {entry}(" in text
    assert "triton" not in (PKG / "kernels.py").read_text()


def test_examples_tools_and_smoke_name_no_jax():
    """``examples_torch/``, ``tools/`` and ``chip_smoke.py`` import none of
    ``jax``, ``jaxlib`` and ``jets_tpu``."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jets_tpu)(\s|\.|$)", re.M)
    files = [*(ROOT / "examples_torch").glob("*.py"), *(ROOT / "tools").glob("*.py"),
             ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [str(p.relative_to(ROOT)) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders


def test_smoke_example_phase_runs_without_jax():
    """``chip_smoke.py``'s example phase, the part a CPU can run, with
    ``jax``, ``jaxlib`` and ``jets_tpu`` blocked: its runner runs an example
    as ``__main__``, its CPU half runs an example's ``main(device="cpu")``
    and writes what it prints (one example: tests/test_torch_examples.py
    runs them all), and the card's printed numbers are held to the CPU's by
    the same comparison (here 13's run as ``__main__`` against its
    ``main``); every example has a tolerance for each number it prints."""
    script = r"""
import sys, json, tempfile, os
for name in ("jax", "jaxlib", "jets_tpu"):
    sys.modules[name] = None
import chip_smoke as cs
name = "13_anisotropic_denq_gradient"
assert sorted(cs.EXAMPLE_TOL) == sorted(cs.EXAMPLES) and len(cs.EXAMPLES) == 13
out, sec = cs.run_example(name, ["--device", "cpu"])
assert "VTI+staticQ" in out and sec > 0
path = os.path.join(tempfile.mkdtemp(), "cpu.json")
cs.EXAMPLES = (name,)
assert cs.examples_cpu_main(path) == 0
res = json.load(open(path))
assert sorted(res) == [name]
assert cs._printed_close(out, res[name]["out"], cs.EXAMPLE_TOL[name], name) == \
    [0.0] * len(cs.EXAMPLE_TOL[name])
bad = sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "jaxlib", "jets_tpu"))
assert not bad, bad
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
