"""Rank process of the port's multi-rank tests (``tests/test_torch_parallel.py``,
``test_torch_hetero.py``, ``test_torch_multiprocess.py``, ``test_torch_slab.py``,
``test_torch_configs.py``) — the counterpart of ``tests/_mp_worker.py``.

One gloo rank on the CPU, with ``jax``, ``jaxlib`` and ``jets_tpu`` blocked
from import: it joins the group through a ``FileStore`` rendezvous (no
port, so parallel pytest workers never race for one), runs one battery of
the port's distribution layer on the inputs the test wrote (numpy arrays,
the JAX package's draws among them) and saves what the test asserts on,
one ``.npz`` per rank. Invoked as::

    python _torch_mp_worker.py <battery> <rank> <world> <store file> <inputs.npz> <out prefix>

:func:`spawn` starts the ranks of one world with a hard timeout of their
own and ``init_process_group(timeout=...)`` below it, so a hung collective
fails the test instead of running the suite into its time limit.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COLLECTIVE_TIMEOUT = 60.0  # seconds; each spawn's own limit is above it


def spawn(battery, world, tmp_path, inputs, timeout=150):
    """Run ``battery`` on ``world`` gloo ranks over ``inputs`` (a dict of
    numpy arrays); returns the ranks' results, a list of dicts of arrays."""
    import numpy as np

    tmp = str(tmp_path)
    inp = os.path.join(tmp, f"{battery}_{world}_in.npz")
    np.savez(inp, **inputs)
    store = os.path.join(tmp, f"{battery}_{world}_store")
    out = os.path.join(tmp, f"{battery}_{world}_out")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, battery, str(r), str(world), store,
                               inp, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{battery} rank {r}/{world} failed (rc {p.returncode}):\n{log}"
    return [dict(np.load(f"{out}_r{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# batteries: each takes (inputs, mesh) and returns a dict of numpy arrays
# ---------------------------------------------------------------------------


def _np(x):
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def battery_parallel(inp, mesh):
    """tests/test_parallel.py's checks: the stacked operator (hand-written
    and derived adjoints, both shot modes), the seismic operator, LSQR,
    the runner, Chebyshev, and map-mode multishot on the mesh."""
    import numpy as np
    import torch

    import jets_tpu_torch as tt
    from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
    from jets_tpu_torch.core.blockspace import BlockVector
    from jets_tpu_torch.ops.wave import (multishot_tti_wave_operator,
                                         multishot_vti_wave_operator, multishot_wave_operator)
    from jets_tpu_torch.parallel import runner
    from jets_tpu_torch.parallel.collectives import gather_blocks
    from jets_tpu_torch.parallel.sharded import ShardedSpace, shard_blocks, stacked_block_operator
    from jets_tpu_torch.solvers import chebyshev, lsqr, normal_operator

    cpu, f64 = torch.device("cpu"), torch.float64
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}
    w = T(inp["stk_w"])
    n = w.shape[1]
    for name, derived, shot_map in (("hand", False, "vmap"), ("derived_vmap", True, "vmap"),
                                    ("derived_map", True, "map")):
        A = stacked_block_operator(
            nblocks=w.shape[0], dom=tt.Space((n,), f64, cpu), rng_block=tt.Space((n,), f64, cpu),
            bstate={"w": w}, df=lambda dm, m0, bs: bs["w"] * dm,
            dft=None if derived else (lambda dd, m0, bs: bs["w"] * dd), mesh=mesh,
            shot_map=shot_map)
        out[f"stk_{name}_fwd"] = _np(gather_blocks(A(T(inp["stk_m"])), w.shape[0], mesh))
        out[f"stk_{name}_adj"] = _np(A.H(shard_blocks(inp["stk_dd"], mesh)))
        g = torch.Generator().manual_seed(5)
        out[f"stk_{name}_gate"] = np.array([float(v) for v in tt.dot_product_test(
            A, A.dom.randn(g), A.rng.randn(g))])
    assert isinstance(A.rng, ShardedSpace) and A.rng.local_shape[0] == w.shape[0] // mesh.size

    def seis(key):
        return seismic_operator_from_arrays(
            tuple(inp[f"{key}_grid"]), int(inp[f"{key}_wr"].shape[0]),
            int(inp[f"{key}_wr"].shape[1]), wr=inp[f"{key}_wr"],
            rcv=inp[f"{key}_rcv"] if f"{key}_rcv" in inp else None, mesh=mesh, dtype=f64)

    As = seis("seis")
    out["seis_fwd"] = _np(gather_blocks(As(T(inp["seis_m"])), As.rng.shape[0], mesh))
    out["seis_adj"] = _np(As.H(shard_blocks(inp["seis_d"], mesh)))
    g = torch.Generator().manual_seed(6)
    out["seis_gate"] = np.array([float(v) for v in tt.dot_product_test(
        As, As.dom.randn(g), As.rng.randn(g))])

    Al = seis("lsqr")
    d = shard_blocks(inp["lsqr_d"], mesh)
    r = lsqr(Al, d, maxiter=50, tol=1e-12)
    out["lsqr_x"], out["lsqr_resnorm"] = _np(r.x), float(r.resnorm)
    out["lsqr_true_res"] = float(Al.rng.norm(Al(r.x) - d))

    lo, hi = runner.local_block_range(16, mesh)
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = runner.assemble_global(data[lo:hi], (16, 3), mesh)
    out["runner_range"] = np.array([lo, hi])
    out["runner_slab"] = _np(arr)
    try:
        runner.local_block_range(15, mesh)
        out["runner_refuses_15"] = False
    except ValueError:
        out["runner_refuses_15"] = True
    try:
        runner.assemble_global(data[:hi - lo + 1], (16, 3), mesh)
        out["runner_refuses_shape"] = False
    except ValueError:
        out["runner_refuses_shape"] = True

    Ac = seis("cheb")
    N = normal_operator(Ac, damp=0.5)
    b = Ac.adjoint_apply(shard_blocks(inp["cheb_d"], mesh))
    lmin, lmax = (float(v) for v in inp["cheb_bounds"])
    rc = chebyshev(N, b, lmin, lmax, maxiter=200, tol=1e-10, check_every=10)
    out["cheb_x"] = _np(rc.x)

    grid = tuple(int(v) for v in inp["ms_grid"])
    kw = dict(nt=20, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3, dtype=f64, device=cpu)
    Fs = multishot_wave_operator(grid, inp["ms_srcs"], mesh=mesh, shot_map="map", **kw)
    c = torch.full(grid, 2000.0, dtype=f64)
    out["ms_fwd"] = _np(gather_blocks(Fs(c), len(inp["ms_srcs"]), mesh))
    Js = Fs.linearize(c)
    g = torch.Generator().manual_seed(7)
    out["ms_gate"] = np.array([float(v) for v in tt.dot_product_test(
        Js, Js.dom.randn(g), Js.rng.randn(g))])
    out["ms_adj"] = _np(Js.H(shard_blocks(inp["ms_dd"], mesh)))

    srcs = inp["aniso_srcs"]
    for name, make in (("vti", multishot_vti_wave_operator),
                       ("tti", multishot_tti_wave_operator)):
        for shot_map in ("map", "vmap"):
            F = make(tuple(int(v) for v in inp["aniso_grid"]), srcs, nt=24, dt=8e-4,
                     dx=10.0, freq=18.0, sponge_width=3, shot_map=shot_map, mesh=mesh,
                     dtype=f64)
            m = BlockVector([T(b) for b in inp[f"{name}_m"]], F.dom)
            out[f"{name}_{shot_map}_fwd"] = _np(gather_blocks(F(m), len(srcs), mesh))
            g = F.linearize(m).H(shard_blocks(inp[f"{name}_dd"], mesh))
            out[f"{name}_{shot_map}_adj"] = np.stack([_np(b) for b in g])
    return out


def battery_hetero(inp, mesh):
    """tests/test_hetero.py's checks on the mesh."""
    import numpy as np
    import torch

    import jets_tpu_torch as tt
    from jets_tpu_torch.ops.diagonal import diagonal_operator
    from jets_tpu_torch.ops.matrix import matrix_operator
    from jets_tpu_torch.parallel.hetero import distribute_block_rows
    from jets_tpu_torch.solvers import lsqr

    cpu = torch.device("cpu")

    def rows(prefix):
        mats = [matrix_operator(a, device=cpu) for a in inp[f"{prefix}_mats"]]
        diags = [diagonal_operator(a, device=cpu) for a in inp[f"{prefix}_diags"]]
        return mats + diags

    out = {}
    lay = distribute_block_rows(rows("mix"), mesh)
    out["groups"] = np.array([len(g) for g in lay.groups])
    out["group_rows"] = np.concatenate([np.array(g) for g in lay.groups])
    out["sharded"] = np.array(lay.sharded)
    A = lay.operator
    got = lay.unpack(A(torch.from_numpy(inp["mix_m"])))
    out["fwd"] = np.stack([_np(b) for b in got[:16]])
    out["fwd_diag"] = np.stack([_np(b) for b in got[16:]])
    blocks = list(inp["ref_d_mats"]) + list(inp["ref_d_diags"])
    out["adj"] = _np(A.adjoint_apply(lay.pack(blocks)))

    lay3 = distribute_block_rows(rows("gate"), mesh)
    g = torch.Generator().manual_seed(2)
    out["gate"] = np.array([float(v) for v in tt.dot_product_test(
        lay3.operator, lay3.operator.dom.randn(g), lay3.operator.rng.randn(g))])

    lay5 = distribute_block_rows(rows("lsqr"), mesh)
    b = lay5.pack(list(inp["lsqr_b_mats"]) + list(inp["lsqr_b_diags"]))
    out["lsqr_x"] = _np(lsqr(lay5.operator, b, maxiter=60, tol=1e-13).x)

    lay9 = distribute_block_rows(rows("fallback"), mesh)
    out["fallback_sharded"] = np.array(lay9.sharded)
    got9 = lay9.unpack(lay9.operator(torch.from_numpy(inp["fallback_m"])))
    out["fallback_fwd_mats"] = np.stack([_np(b) for b in got9[:3]])
    out["fallback_fwd_diags"] = np.stack([_np(b) for b in got9[3:]])
    return out


def battery_multiprocess(inp, mesh):
    """tests/test_multiprocess.py's workflow: a genuinely partial block
    range, host-local data for it only, the rank's slab assembled, and a
    distributed LSQR."""
    import numpy as np
    import torch

    from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
    from jets_tpu_torch.parallel import runner
    from jets_tpu_torch.solvers import lsqr

    nshots, nrecv = (int(v) for v in inp["wr"].shape)
    lo, hi = runner.local_block_range(nshots, mesh)
    assert hi - lo == nshots // mesh.size and lo == mesh.rank * (nshots // mesh.size)
    A = seismic_operator_from_arrays(tuple(inp["grid"]), nshots, nrecv, wr=inp["wr"],
                                     mesh=mesh, dtype=torch.float64)
    assert A.jet.state["bstate"]["wr"].shape[0] == hi - lo  # only this rank's shots
    d_local = np.stack([np.random.default_rng(1000 + s).standard_normal(nrecv)
                        for s in range(lo, hi)])
    d = runner.assemble_global(d_local, (nshots, nrecv), mesh)
    res = lsqr(A, d, maxiter=40, tol=0.0)
    assert int(res.iterations) == 40
    return {"x": _np(res.x), "resnorm": float(res.resnorm), "lo": lo, "hi": hi}


def battery_slab(inp, mesh):
    """tests/test_gspmd.py:63 and :256 for the isotropic z-slab: the plain
    and K4-route forwards, the autodiff gradient and the stored f32 and
    int8 adjoints, each against the port's unsharded run on this rank, and
    the refusals."""
    import numpy as np
    import torch

    from jets_tpu_torch.ops.wave import fits_fused_sharded, wave_propagator
    from jets_tpu_torch.parallel.collectives import gather_blocks
    from jets_tpu_torch.parallel.sharded import BlockSharding, block_sharding, shard_blocks

    cpu = torch.device("cpu")
    ws = block_sharding(mesh, "grid")
    out = {}
    for case in ("a", "b"):
        shape = tuple(int(v) for v in inp[f"{case}_shape"])
        kw = dict(nt=14, dt=8e-4, dx=10.0, freq=18.0, src_idx=int(inp[f"{case}_src"]),
                  rcv_idx=inp[f"{case}_rcv"], sponge_width=3)
        c = torch.from_numpy(inp[f"{case}_c"])
        c_l = shard_blocks(c, mesh, "grid")
        dd = torch.from_numpy(inp[f"{case}_dd"])
        for fused in (False, True):
            tag = f"{case}_{'k4' if fused else 'plain'}"
            F0 = wave_propagator(shape, fused=fused, device=cpu, **kw)
            Fs = wave_propagator(shape, fused=fused, wavefield_sharding=ws, **kw)
            assert Fs.dom.local_shape == c_l.shape and Fs.dom.device == mesh.device
            d0, ds = F0(c), Fs(c_l)
            out[f"{tag}_fwd"] = _np(ds)
            out[f"{tag}_fwd_bitwise"] = bool(torch.equal(d0, ds))
            cg = c_l.clone().requires_grad_()
            (gs,) = torch.autograd.grad(torch.sum(Fs(cg) ** 2), cg)
            out[f"{tag}_grad"] = _np(gather_blocks(gs, shape[0], mesh, "grid"))
            J0, Js = F0.linearize(c), Fs.linearize(c_l)
            dm = torch.from_numpy(inp[f"{case}_dm"])
            out[f"{tag}_jvp_bitwise"] = bool(torch.equal(
                J0(dm), Js(shard_blocks(dm, mesh, "grid"))))
            for store in ("f32", "int8"):
                F0s = wave_propagator(shape, fused=fused, store_adjoint=store, device=cpu,
                                      **kw)
                Fss = wave_propagator(shape, fused=fused, store_adjoint=store,
                                      wavefield_sharding=ws, **kw)
                a0 = shard_blocks(F0s.linearize(c).H(dd), mesh, "grid")
                a1 = Fss.linearize(c_l).H(dd)
                out[f"{tag}_{store}_adj"] = _np(gather_blocks(a1, shape[0], mesh, "grid"))
                out[f"{tag}_{store}_adj_vs_unsharded"] = float((a1 - a0).abs().max())
    out.update(_slabs_2d(inp))
    refusals = {}
    for name, shape, order, spec in (("not_3d", (16, 16), 2, ("grid",)),
                                     ("indivisible", (4 * mesh.size + 1, 8, 16), 2, ("grid",)),
                                     ("thin_slab", (2 * mesh.size, 8, 16), 8, ("grid",)),
                                     ("not_z_only", (16, 8, 16), 2, ("grid", "grid")),
                                     ("not_a_sharding", (16, 8, 16), 2, None)):
        s = object() if spec is None else BlockSharding(mesh, spec)
        try:
            wave_propagator(shape, nt=4, space_order=order, wavefield_sharding=s)
            refusals[name] = "none"
        except (ValueError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
        if spec is not None:
            out[f"fits_{name}"] = fits_fused_sharded(shape, torch.float32, order, s)
    out["fits_f64"] = fits_fused_sharded((16, 8, 16), torch.float64, 2, ws)
    out["fits_ok"] = fits_fused_sharded((16, 8, 16), torch.float32, 2, ws)
    out["refusals"] = np.array([f"{k}={v}" for k, v in refusals.items()])
    return out


SPECS = {"y": (None, "grid"), "pencil": ("block", "grid"), "tuple": (("block", "grid"),)}


def _slabs_2d(inp):
    """The iso, VTI and TTI propagators on a 2-D mesh of the world ((1, 2) on
    2 ranks, (2, 2) on 4) under each spec of :data:`SPECS`, and the 2-D iso
    and VTI grids under the pencil: traces, the int8 stored adjoint
    (gathered) and whether both are bitwise the port's unsharded plain run
    on this rank; then the refusals that stay (``fused=True`` under a VTI
    or TTI sharding, TTI on a 2-D grid)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from jets_tpu_torch import BlockVector
    from jets_tpu_torch.ops.wave import (tti_wave_propagator, vti_wave_propagator,
                                         wave_propagator)
    from jets_tpu_torch.parallel.collectives import halo_counts, reset_halo_counts
    from jets_tpu_torch.parallel.gspmd import make_mesh_2d
    from jets_tpu_torch.parallel.sharded import BlockSharding

    cpu, world = torch.device("cpu"), dist.get_world_size()
    mesh = make_mesh_2d(world // 2, 2, device="cpu")
    makes = {"iso": wave_propagator, "vti": vti_wave_propagator, "tti": tti_wave_propagator}
    out = {}
    for case in ("iso", "vti", "tti", "iso2d", "vti2d"):
        physics = case[:3]
        shape = tuple(int(v) for v in inp[f"s2_{case}_shape"])
        kw = dict(nt=10, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
                  src_idx=int(inp[f"s2_{case}_src"]), rcv_idx=inp[f"s2_{case}_rcv"])
        make = makes[physics]
        F0 = make(shape, fused=False, device=cpu, **kw)
        A0 = make(shape, fused=False, store_adjoint="int8", device=cpu, **kw)
        c = torch.from_numpy(inp[f"s2_{case}_c"])
        vals = (0.1, 0.05, 0.2, 0.7)[:{"iso": 0, "vti": 2, "tti": 4}[physics]]
        blocks = [c] + [torch.full(shape, v) for v in vals]
        m0 = c if physics == "iso" else BlockVector(blocks, F0.dom)
        dd = torch.from_numpy(inp[f"s2_{case}_dd"])
        d0, a0 = F0(m0), A0.linearize(m0).H(dd)
        a0 = [a0] if physics == "iso" else list(a0)
        for sname in (SPECS if case in ("iso", "vti", "tti") else ("pencil",)):
            ws = BlockSharding(mesh, SPECS[sname])
            Fs = make(shape, wavefield_sharding=ws, **kw)
            sub = Fs.dom if physics == "iso" else Fs.dom.subspace(0)
            ms = sub.local(c) if physics == "iso" else BlockVector(
                [sub.local(b).contiguous() for b in blocks], Fs.dom)
            reset_halo_counts()
            ds = Fs(ms)
            tag = f"s2_{case}_{sname}"
            out[f"{tag}_halos"] = sum(halo_counts().values())
            out[f"{tag}_fwd"] = _np(ds)
            out[f"{tag}_fwd_bitwise"] = bool(torch.equal(ds, d0))
            As = make(shape, wavefield_sharding=ws, store_adjoint="int8", **kw)
            a1 = As.linearize(ms).H(dd)
            a1 = [a1] if physics == "iso" else list(a1)
            out[f"{tag}_adj"] = np.stack([_gather_all(b, shape, mesh, ws) for b in a1])
            out[f"{tag}_adj_bitwise"] = all(torch.equal(x, sub.local(y))
                                            for x, y in zip(a1, a0))
            out[f"{tag}_local"] = np.array(sub.local_shape)
    pencil = BlockSharding(mesh, SPECS["pencil"])
    for name, fn in (
            ("vti_fused", lambda: vti_wave_propagator((16, 8, 16), nt=4, fused=True,
                                                      wavefield_sharding=pencil)),
            ("tti_fused", lambda: tti_wave_propagator((16, 8, 16), nt=4, fused=True,
                                                      wavefield_sharding=pencil)),
            ("tti_2d", lambda: tti_wave_propagator((16, 16), nt=4,
                                                   wavefield_sharding=pencil)),
            ("vti_indivisible", lambda: vti_wave_propagator(
                (16, 7, 16), nt=4, wavefield_sharding=pencil)),
            ("tti_thin", lambda: tti_wave_propagator(
                (16, 6, 16), nt=4, space_order=8,
                wavefield_sharding=BlockSharding(mesh, (None, "grid")))),
            ("unknown_axis", lambda: wave_propagator((16, 8, 16), nt=4,
                                                     wavefield_sharding=BlockSharding(
                                                         mesh, ("shots",))))):
        out[f"s2_refuse_{name}"] = _refusal(fn)
    return out


def _gather_all(x, shape, mesh, ws):
    """The global array from each rank's slab of ``ws``."""
    import torch

    from jets_tpu_torch.parallel.collectives import sum_replicated
    from jets_tpu_torch.parallel.sharded import local_slices

    g = torch.zeros(shape, dtype=x.dtype)
    g[local_slices(shape, mesh, ws.spec)] = x
    return _np(sum_replicated(g, mesh, ws.axes))


def battery_configs(inp, mesh):
    """Configs 4 and 5 of tests/test_torch_configs.py on the mesh, with the
    JAX package's weights: the operator on random members, LSQR on the JAX
    package's data for the stable iterations and for the full budget, and
    the port's own problem through ``run_config``."""
    import json

    import numpy as np
    import torch

    from jets_tpu_torch.models import configs as cfg
    from jets_tpu_torch.parallel.collectives import gather_blocks
    from jets_tpu_torch.parallel.sharded import shard_blocks

    out = {}
    for name in ("config4_distributed_lsqr", "config5_seismic3d_pod"):
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in json.loads(str(inp[f"{name}:kw"])).items()}
        kw.update(mesh=mesh, dtype=torch.float64)
        A, solve, _, _ = getattr(cfg, name)(**kw, wr=inp[f"{name}:wr"])
        nb = A.rng.shape[0]
        out[f"{name}:fwd"] = _np(gather_blocks(A(torch.from_numpy(inp[f"{name}:m"])), nb, mesh))
        out[f"{name}:adj"] = _np(A.H(shard_blocks(inp[f"{name}:d"], mesh)))
        stable, maxiter = (int(v) for v in inp[f"{name}:iters"])
        jd = shard_blocks(inp[f"{name}:jd"], mesh)
        r = solve(A, jd, maxiter=stable, tol=1e-10)
        out[f"{name}:x"], out[f"{name}:history"] = _np(r.x), _np(r.history)
        out[f"{name}:iterations"] = int(r.iterations)
        rf = solve(A, jd, maxiter=maxiter, tol=1e-10)
        out[f"{name}:relres_jd"] = float(A.rng.norm(A(rf.x) - jd) / A.rng.norm(jd))
        out[f"{name}:relres_own"] = cfg.run_config(getattr(cfg, name), maxiter=maxiter,
                                                   tol=1e-10, **kw)[1]
    return out


# tests/test_torch_gspmd.py's seismic and multishot cases of the routes a
# grid-sharded model also takes (the JAX references are computed there)
# (key, grid, shots, receivers, impl, the JAX mesh, seed, iterations): 31
# and 23 receivers fit no regular subgrid, so those geometries are
# irregular. The 3-D ones have rank 23, which CGLS has reached by 15
# iterations: there the JAX package's own sharded and unsharded runs part by
# 5e-5 (roundoff past convergence), so they take 8, where both agree to 1e-15.
SEISMIC_CASES = [("irr", (16, 16), 8, 31, "fused", (4, 2), 6, 25),
                 ("comp", (16, 16), 8, 32, "composed", (4, 2), 7, 25),
                 ("irr3", (8, 10, 6), 4, 23, "fused", (2, 4), 8, 8),
                 ("comp3", (8, 10, 6), 4, 23, "composed", (2, 4), 9, 8)]
WINDOW = dict(window_shape=(10, 12), window_corners=[[2, 1], [3, 2], [4, 0], [6, 4]],
              srcs=[5 * 12 + 2, 5 * 12 + 6, 5 * 12 + 8, 5 * 12 + 5])
MULTISHOT_CASES = {"cpml": dict(boundary="cpml"), "win": WINDOW,
                   "win8": dict(WINDOW, store_adjoint="int8")}


def gspmd_on(inp, mesh):
    """tests/test_gspmd.py's nine checks on one (block × grid) mesh, with the
    JAX package's draws: each result gathered to the global array (every
    rank holds its slab only; the shapes are asserted), and each rank's
    halo exchanges counted."""
    import math

    import numpy as np
    import torch

    from jets_tpu_torch import BlockVector
    from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
    from jets_tpu_torch.ops.wave import (multishot_vti_wave_operator,
                                         multishot_wave_operator, tti_wave_propagator,
                                         vti_wave_propagator, wave_propagator)
    from jets_tpu_torch.parallel.collectives import (gather_blocks, halo_counts,
                                                     reset_halo_counts)
    from jets_tpu_torch.parallel.gspmd import constrain_model, shard_data, shard_model
    from jets_tpu_torch.parallel.sharded import BlockSharding, ShardedSpace
    from jets_tpu_torch.solvers import cgls, lsqr

    f64, f32 = torch.float64, torch.float32
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ng = mesh.shape["grid"]
    out = {}

    def grid_all(x, n):
        """The global model from each rank's slab of the leading dimension."""
        return _np(gather_blocks(x, n, mesh, "grid"))

    def data_all(x, n):
        return _np(gather_blocks(x, n, mesh, "block"))

    def counted(key, fn):
        reset_halo_counts()
        r = fn()
        out[f"{key}_halos"] = sum(halo_counts().values())
        return r

    # test_forward_adjoint_match_on_2d_mesh
    A = seismic_operator_from_arrays((16, 16), 8, 32, wr=inp["fa_wr"], mesh=mesh, dtype=f64)
    assert isinstance(A.dom, ShardedSpace) and A.dom.local_shape == (16 // ng, 16)
    m_sh = shard_model(inp["fa_m"], mesh)
    assert constrain_model(m_sh, mesh, shape=(16, 16)) is m_sh
    out["fa_fwd"] = counted("fa_fwd", lambda: data_all(A(m_sh), 8))
    out["fa_adj"] = grid_all(A.H(shard_data(inp["fa_d"], mesh)), 16)

    # test_lsqr_on_2d_mesh_matches_unsharded
    A = seismic_operator_from_arrays((16, 16), 8, 32, wr=inp["ls_wr"], mesh=mesh, dtype=f64)
    r = lsqr(A, shard_data(inp["ls_d"], mesh), maxiter=25, tol=0.0)
    out["ls_x"], out["ls_resnorm"] = grid_all(r.x, 16), float(r.resnorm)

    # test_3d_grid_sharded_cgls
    A = seismic_operator_from_arrays((8, 10, 6), 4, 24, wr=inp["cg_wr"], mesh=mesh, dtype=f64)
    r = cgls(A, shard_data(inp["cg_d"], mesh), x0=shard_model(np.zeros((8, 10, 6)), mesh),
             maxiter=15, tol=0.0)
    out["cg_x"] = grid_all(r.x, 8)

    ws = BlockSharding(mesh, ("grid",))
    shape = (16, 8, 16)
    src = int(np.ravel_multi_index((8, 4, 8), shape))
    kw = dict(nt=14, dt=8e-4, dx=10.0, freq=18.0, src_idx=src, sponge_width=3,
              rcv_idx=[int(np.ravel_multi_index((8, 4, x), shape)) for x in range(16)])

    # test_grid_sharded_wave_propagator_parity_and_halo
    Fs = wave_propagator(shape, wavefield_sharding=ws, **kw)
    c_sh = shard_model(inp["iso_c"], mesh)
    assert Fs.dom.local_shape == tuple(c_sh.shape) == (16 // ng, 8, 16)
    out["iso_fwd"] = counted("iso_fwd", lambda: _np(Fs(c_sh)))
    cg = c_sh.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(Fs(cg) ** 2), cg)
    out["iso_grad"] = grid_all(g, 16)
    Fss = wave_propagator(shape, wavefield_sharding=ws, store_adjoint="f32", **kw)
    out["iso_adj"] = grid_all(Fss.linearize(c_sh).H(T(inp["iso_d"])), 16)
    out["iso_refusal"] = _refusal(lambda: wave_propagator(
        shape, fused=True, wavefield_sharding=BlockSharding(mesh, (None, "grid")), **kw))

    # test_grid_sharded_multishot_block_by_grid and its VTI twin
    grid, srcs = (16, 16), [16 * 8 + 2, 16 * 8 + 6, 16 * 8 + 10, 16 * 8 + 13]
    mkw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3)
    F = multishot_wave_operator(grid, srcs, mesh=mesh, **mkw)
    c = shard_model(np.full(grid, 1500.0, np.float32), mesh)
    out["ms_fwd"] = counted("ms_fwd", lambda: data_all(F(c), 4))
    out["ms_adj"] = grid_all(F.linearize(c).H(shard_data(inp["ms_d0"], mesh)), 16)
    F = multishot_vti_wave_operator(grid, srcs, mesh=mesh, **mkw)
    mv = BlockVector([shard_model(np.full(grid, v, np.float32), mesh)
                      for v in (1500.0, 0.1, 0.05)], F.dom)
    out["msv_fwd"] = counted("msv_fwd", lambda: data_all(F(mv), 4))
    out["msv_adj"] = np.stack([grid_all(b, 16) for b in F.linearize(mv).H(
        shard_data(inp["msv_d0"], mesh))])

    # test_grid_sharded_vti_propagator_parity_and_halo, ..._tti_propagator_parity
    for name, make, vals, nt in (("vti", vti_wave_propagator, (1500.0, 0.1, 0.05), 14),
                                 ("tti", tti_wave_propagator, (1500.0, 0.1, 0.05, 0.2, 0.7),
                                  12)):
        kwp = dict(kw, nt=nt)
        Fs = make(shape, wavefield_sharding=ws, **kwp)
        m = BlockVector([shard_model(np.full(shape, v, np.float32), mesh) for v in vals],
                        Fs.dom)
        out[f"{name}_fwd"] = counted(f"{name}_fwd", lambda: _np(Fs(m)))
        Fss = make(shape, wavefield_sharding=ws, store_adjoint="f32", **kwp)
        a = Fss.linearize(m).H(T(inp[f"{name}_d"]))
        out[f"{name}_adj"] = np.stack([grid_all(b, 16) for b in a])
        out[f"{name}_refusal"] = _refusal(lambda: make(shape, fused=True,
                                                       wavefield_sharding=ws, **kwp))
    out["tti_2d_refusal"] = _refusal(lambda: tti_wave_propagator(
        (16, 16), wavefield_sharding=ws, nt=8))

    # the irregular geometry and impl="composed" on the grid-sharded model
    one = math.prod(mesh.shape.values()) == 1
    for key, shp, ns, nr, impl, _, _, iters in SEISMIC_CASES:
        kwa = dict(wr=inp[f"{key}_wr"], rcv=inp.get(f"{key}_rcv"), impl=impl, dtype=f64)
        A = seismic_operator_from_arrays(shp, ns, nr, mesh=mesh, **kwa)
        assert isinstance(A.dom, ShardedSpace)
        A0 = seismic_operator_from_arrays(shp, ns, nr, device="cpu", **kwa) if one else None
        for tag, op in (("", A), ("_none", A0)):
            if op is None:
                continue
            d = shard_data(inp[f"{key}_d"], mesh) if op is A else T(inp[f"{key}_d"])
            if len(shp) == 2:
                r = lsqr(op, d, maxiter=iters, tol=0.0)
                out[f"{key}_resnorm{tag}"] = float(r.resnorm)
            else:
                x0 = shard_model(np.zeros(shp), mesh) if op is A else torch.zeros(shp, dtype=f64)
                r = cgls(op, d, x0=x0, maxiter=iters, tol=0.0)
            out[f"{key}_x{tag}"] = grid_all(r.x, shp[0]) if op is A else _np(r.x)
        out[f"{key}_fwd"] = counted(f"{key}_fwd", lambda: data_all(
            A(shard_model(np.ones(shp), mesh)), ns))

    # the CPML and Ginsu-windowed multishots on the grid-sharded model
    for key, extra in MULTISHOT_CASES.items():
        kwm = dict(mkw, **{k: v for k, v in extra.items() if k != "srcs"})
        s = extra.get("srcs", srcs)
        F = multishot_wave_operator(grid, s, mesh=mesh, **kwm)
        c = shard_model(inp[f"{key}_c"], mesh)
        out[f"{key}_fwd"] = counted(f"{key}_fwd", lambda: data_all(F(c), 4))
        out[f"{key}_adj"] = grid_all(F.linearize(c).H(shard_data(inp[f"{key}_d0"], mesh)),
                                     16)
        if one:
            F0 = multishot_wave_operator(grid, s, shot_map="map", device="cpu", **kwm)
            c0 = T(inp[f"{key}_c"])
            out[f"{key}_fwd_none"] = _np(F0(c0))
            out[f"{key}_adj_none"] = _np(F0.linearize(c0).H(T(inp[f"{key}_d0"])))
    win = {k: v for k, v in WINDOW.items() if k != "srcs"}
    out["cpml_win_refusal"] = _refusal(lambda: multishot_wave_operator(
        grid, WINDOW["srcs"], mesh=mesh, boundary="cpml", **mkw, **win))
    out["cpml_store_refusal"] = _refusal(lambda: multishot_wave_operator(
        grid, srcs, mesh=mesh, boundary="cpml", store_adjoint="int8", **mkw))

    # test_fused_sharded_step_parity_and_collectives
    shape = (16, 8, 128)
    kwf = dict(kw, src_idx=int(np.ravel_multi_index((8, 4, 64), shape)),
               rcv_idx=[int(np.ravel_multi_index((8, 4, x), shape)) for x in range(128)])
    Ff = wave_propagator(shape, wavefield_sharding=ws, fused=True, **kwf)
    Fx = wave_propagator(shape, wavefield_sharding=ws, fused=False, **kwf)
    c_sh = shard_model(inp["fu_c"], mesh)
    out["fu_fwd"] = counted("fu_fwd", lambda: _np(Ff(c_sh)))
    out["fu_vs_plain"] = float((Ff(c_sh) - Fx(c_sh)).abs().max())
    cg = c_sh.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(Ff(cg) ** 2), cg)
    out["fu_grad"] = grid_all(g, 16)
    out["fu_refusal"] = _refusal(lambda: wave_propagator(
        (16, 8, 16), wavefield_sharding=BlockSharding(mesh, (None, "grid")), fused=True,
        nt=8, src_idx=0, sponge_width=2))
    return out


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "none"


def battery_gspmd(inp, _):
    """:func:`gspmd_on` on the (2, 2) and (1, 4) meshes of the 4 ranks."""
    from jets_tpu_torch.parallel.gspmd import make_mesh_2d

    out = {"mesh_too_big": _refusal(lambda: make_mesh_2d(2, 4, device="cpu")),
           "mesh_too_small": _refusal(lambda: make_mesh_2d(1, 2, device="cpu"))}
    for nb, ng in ((2, 2), (1, 4)):
        mesh = make_mesh_2d(nb, ng, device="cpu")
        assert mesh.shape == {"block": nb, "grid": ng} and mesh.backend == "gloo"
        out.update({f"{nb}x{ng}:{k}": v for k, v in gspmd_on(inp, mesh).items()})
    return out


def _dcp_problem(mesh):
    """The grid-sharded seismic problem the checkpoint batteries save and
    load: (8, 10, 6), 4 shots, 24 receivers, float64, seed 5."""
    import torch

    from jets_tpu_torch.models.seismic import make_seismic_problem

    return make_seismic_problem((8, 10, 6), 4, 24, seed=5, noise=0.02, mesh=mesh,
                                dtype=torch.float64)


def _dcp_tree(A, state):
    """The LSQR state with its sharded leaves as DTensors."""
    return state._replace(x=A.dom.to_dtensor(state.x), v=A.dom.to_dtensor(state.v),
                          w=A.dom.to_dtensor(state.w), u=A.rng.to_dtensor(state.u))


def _dcp_gathered(A, mesh, state):
    from jets_tpu_torch.parallel.collectives import gather_blocks

    g = {k: _np(gather_blocks(getattr(state, k), 8, mesh, "grid")) for k in "xvw"}
    g["u"] = _np(gather_blocks(state.u, 4, mesh, "block"))
    g.update({k: _np(getattr(state, k)) for k in ("alpha", "phibar", "rhobar")})
    g["i"] = int(state.i)
    return g


def battery_dcp_save(inp, _):
    """Five LSQR iterations on the (1, world) mesh, the state written with
    :func:`save_checkpoint_orbax` (each rank its slabs), and the gathered
    state returned."""
    import torch.distributed as dist

    from jets_tpu_torch.parallel.gspmd import make_mesh_2d
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.utils import save_checkpoint_orbax

    mesh = make_mesh_2d(1, dist.get_world_size(), device="cpu")
    A, _, d = _dcp_problem(mesh)
    st = lsqr(A, d, maxiter=5, tol=0.0).state
    save_checkpoint_orbax(str(inp["path"]), _dcp_tree(A, st))
    return _dcp_gathered(A, mesh, st)


def battery_dcp_load(inp, _):
    """The checkpoint of :func:`battery_dcp_save` loaded on a (2, world/2)
    mesh, ``like`` giving this mesh's layout: the gathered state, and five
    more LSQR iterations resumed from it."""
    import torch
    import torch.distributed as dist

    from jets_tpu_torch.parallel.gspmd import make_mesh_2d
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.utils import load_checkpoint_orbax

    mesh = make_mesh_2d(2, dist.get_world_size() // 2, device="cpu")
    A, _, d = _dcp_problem(mesh)
    like = lsqr(A, d, maxiter=1, tol=0.0).state
    back = load_checkpoint_orbax(str(inp["path"]), _dcp_tree(A, like))
    st = back._replace(x=A.dom.from_dtensor(back.x), v=A.dom.from_dtensor(back.v),
                       w=A.dom.from_dtensor(back.w), u=A.rng.from_dtensor(back.u))
    out = _dcp_gathered(A, mesh, st)
    assert isinstance(st.alpha, torch.Tensor) and isinstance(st.i, int)
    out["resumed_x"] = _dcp_gathered(A, mesh, lsqr(A, d, maxiter=10, tol=0.0,
                                                   state=st).state)["x"]
    return out


BATTERIES = {"parallel": battery_parallel, "hetero": battery_hetero,
             "multiprocess": battery_multiprocess, "slab": battery_slab,
             "configs": battery_configs, "gspmd": battery_gspmd,
             "dcp_save": battery_dcp_save, "dcp_load": battery_dcp_load}


def main():
    battery, rank, world, store, inp_path, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    for name in ("jax", "jaxlib", "jets_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from jets_tpu_torch.parallel import runner
    from jets_tpu_torch.parallel.sharded import make_block_mesh

    assert runner.init_distributed(device="cpu", init_method=f"file://{store}", rank=rank,
                                   world_size=world, timeout=COLLECTIVE_TIMEOUT) == rank
    axis = "grid" if battery == "slab" else "block"
    mesh = make_block_mesh(axis=axis, device="cpu")  # the 2-D batteries make their own
    assert mesh.shape == {axis: world} and mesh.backend == "gloo"
    inp = dict(np.load(inp_path))
    res = BATTERIES[battery](inp, mesh)
    np.savez(f"{out}_r{rank}.npz", **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
