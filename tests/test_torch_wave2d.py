"""The batched 2-D pair K4-2D/K5-2D (``cuda_wave.fused_leapfrog_step2d`` and
``fused_adjoint_step2d``) on the CPU: their plain versions against the JAX
package's 2-D XLA step (run eagerly, so both round every multiply and add:
bitwise), the wrappers' plain route, the batching rule under
``torch.func.vmap`` and the tangent under ``torch.func.jvp`` (bitwise a
per-shot loop and the plain step's forward-mode autodiff), and the routing
of ``ops/wave.py``: a 2-D isotropic grid takes the pair (``fused=True`` here,
where the wrappers run their plain versions; ``fused=None`` on the card),
bit for bit the plain route in every transform, while every other 2-D
physics and a 3-D ``"vmap"`` stack keep their plain steps.

The CUDA kernels run only on a card, where ``chip_smoke.py`` (phase 70) holds
them bitwise against the plain versions tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import cuda_wave as cw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")
B, H, W = 3, 29, 37
ZERO = {"fused_leapfrog_step": 0, "fused_adjoint_step": 0, "fused_q_step": 0,
        "fused_leapfrog_step2d": 0, "fused_adjoint_step2d": 0, "fused_q_adjoint_step": 0}
PLAIN_K4, PLAIN_K5 = cw.fused_leapfrog_step2d_torch, cw.fused_adjoint_step2d_torch


def _fields(n, seed, shape=(B, H, W)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(n)]


def _c2(seed, shape=(B, H, W)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.05 + 0.1 * rng.random(shape)).astype(np.float32))


def _sponge():
    return tw._sponge((H, W), 5, free_surface=True)


def _src():
    return torch.tensor([(4 + 7 * b) * W + 3 + 11 * b for b in range(B)])


def _history(store, u):
    """``(q, sc)`` of ``u`` (B, H, W) per shot under the JAX package's codec."""
    enc, dec = jw._store_codec(store, jnp.float32)
    qs, scs = [], []
    for b in range(u.shape[0]):
        q, s = enc(jnp.asarray(u[b].numpy()))
        qs.append(torch.from_numpy(np.asarray(q.astype(jnp.float32)))
                  if store == "bf16" else torch.from_numpy(np.asarray(q)))
        scs.append(float(np.asarray(s / 127.0 if store == "int8" else s)))
    q = torch.stack(qs)
    return (q.to(torch.bfloat16) if store == "bf16" else q), torch.tensor(scs)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_leapfrog2d_plain_matches_jax_step(order):
    """Each shot of the batched plain K4-2D is the JAX package's 2-D XLA
    step ``_mul_sponge(2u − u_prev + c²dt²·L(u), S) + s_t·mask``, eager."""
    up, u = _fields(2, order)
    c2, S, src = _c2(order + 1), _sponge(), _src()
    s_t, amp = torch.tensor(0.37), torch.tensor(2.5e-3)
    got = cw.fused_leapfrog_step2d_torch(up, u, c2, S, s_t, src, amp, order=order)
    for b in range(B):
        J = [jnp.asarray(x.numpy()) for x in (up[b], u[b], c2[b], S)]
        mask = jw._iota_src_mask((H, W), int(src[b]), jnp.float32(2.5e-3))
        ref = jw._mul_sponge(2.0 * J[1] - J[0] + J[2] * jw._laplacian(J[1], order=order),
                             J[3]) + jnp.float32(0.37) * mask
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
    assert float(got.abs().max()) > 0.0


@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_adjoint2d_plain_matches_jax_step(order, store):
    """Each shot of the batched plain K5-2D is the JAX package's 2-D reverse
    step (``bstep`` of ``_adjoint_stored`` without the receivers'
    injection), its snapshot decoded by the JAX codec."""
    a1, a2, gc2, u = _fields(4, 10 + order)
    c2, S = _c2(20 + order), _sponge()
    q, sc = _history(store, u)
    core, gnew = cw.fused_adjoint_step2d_torch(a1, a2, gc2, c2, q, sc, S, order=order)
    _, dec = jw._store_codec(store, jnp.float32)
    enc, _ = jw._store_codec(store, jnp.float32)
    for b in range(B):
        J = [jnp.asarray(x.numpy()) for x in (a1[b], a2[b], gc2[b], c2[b], S)]
        u_k = dec(*enc(jnp.asarray(u[b].numpy())))
        ebar = jw._mul_sponge(J[0], J[4])
        g_ref = J[2] + jw._laplacian(u_k, order=order) * ebar
        c_ref = (2.0 * ebar + jw._laplacian(J[3] * ebar, order=order)
                 - jw._mul_sponge(J[1], J[4]))
        np.testing.assert_array_equal(core[b].numpy(), np.asarray(c_ref))
        np.testing.assert_array_equal(gnew[b].numpy(), np.asarray(g_ref))
    assert float(gnew.abs().max()) > 0.0


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers are their plain versions (fresh, in place,
    unbatched as B = 1, operands shared by the batch) and launch nothing."""
    up, u, a1, a2, gc2 = _fields(5, 30)
    c2, S, src = _c2(31), _sponge(), _src()
    s_t, amp = torch.tensor(0.5), torch.tensor(1e-3)
    q = (64 * u).to(torch.int8)
    sc = torch.tensor([0.01, 0.02, 0.03])
    cw.reset_launch_counts()
    ref = cw.fused_leapfrog_step2d_torch(up, u, c2, S, s_t, src, amp, order=8)
    assert torch.equal(cw.fused_leapfrog_step2d(up, u, c2, S, s_t, src, amp, order=8), ref)
    one = cw.fused_leapfrog_step2d(up[1], u[1], c2[1], S, 0.5, int(src[1]), 1e-3, order=8)
    assert one.shape == (H, W) and torch.equal(one, ref[1])
    shared = cw.fused_leapfrog_step2d(up, u, c2[0], S, s_t, src, amp, order=8)
    assert torch.equal(shared, cw.fused_leapfrog_step2d_torch(up, u, c2[0], S, s_t, src,
                                                               amp, order=8))
    upk = up.clone()
    assert cw.fused_leapfrog_step2d(upk, u, c2, S, s_t, src, amp, order=8, out=upk) is upk
    assert torch.equal(upk, ref)
    core_r, g_r = cw.fused_adjoint_step2d_torch(a1, a2, gc2, c2, q, sc, S, order=4)
    core, g = cw.fused_adjoint_step2d(a1, a2, gc2, c2, q, sc, S, order=4)
    assert torch.equal(core, core_r) and torch.equal(g, g_r)
    c1, g1 = cw.fused_adjoint_step2d(a1[2], a2[2], gc2[2], c2[2], q[2], sc[2], S, order=4)
    assert torch.equal(c1, core_r[2]) and torch.equal(g1, g_r[2])
    core, g = cw.fused_adjoint_step2d(a1, a2, gc2, c2, q, sc, S, order=4, inplace=True)
    assert core is a2 and g is gc2 and torch.equal(a2, core_r) and torch.equal(gc2, g_r)
    assert cw.launch_counts() == ZERO


def test_wrappers_reject_what_the_kernels_do_not_take():
    up, u, a1, a2, gc2 = _fields(5, 40)
    c2, S, src = _c2(41), _sponge(), _src()
    args = (c2, S, 1.0, src, 1.0)
    with pytest.raises(TypeError, match="float32"):
        cw.fused_leapfrog_step2d(up.double(), u, *args)
    with pytest.raises(TypeError, match="int64"):
        cw.fused_leapfrog_step2d(up, u, c2, S, 1.0, src.int(), 1.0)
    with pytest.raises(ValueError, match="H, W"):
        cw.fused_leapfrog_step2d(up, u, c2[None], S, 1.0, src, 1.0)
    with pytest.raises(ValueError, match="must have shape"):
        cw.fused_leapfrog_step2d(up[None], u[None], *args)
    with pytest.raises(ValueError, match="order"):
        cw.fused_leapfrog_step2d(up, u, *args, order=6)
    with pytest.raises(ValueError, match="sponge must have shape"):
        cw.fused_leapfrog_step2d(up, u, c2, S[:-1], 1.0, src, 1.0)
    with pytest.raises(ValueError, match="batches of"):
        cw.fused_leapfrog_step2d(up, u[:2], *args)
    with pytest.raises(ValueError, match="planes must be contiguous"):
        cw.fused_leapfrog_step2d(up.transpose(1, 2).contiguous().transpose(1, 2), u, *args)
    with pytest.raises(ValueError, match="distinct"):
        cw.fused_leapfrog_step2d(u, u, *args)
    with pytest.raises(ValueError, match="out must be"):
        cw.fused_leapfrog_step2d(up, u, *args, out=u.clone())
    with pytest.raises(ValueError, match="whole batch"):
        cw.fused_leapfrog_step2d(up[0], u, *args, out=up[0])
    with pytest.raises(TypeError, match="history"):
        cw.fused_adjoint_step2d(a1, a2, gc2, c2, u.half(), 1.0, S)
    with pytest.raises(ValueError, match="distinct"):
        cw.fused_adjoint_step2d(a1, a1, gc2, c2, u, 1.0, S)
    with pytest.raises(ValueError, match="whole batch"):
        cw.fused_adjoint_step2d(a1, a2[0], gc2, c2, u, 1.0, S, inplace=True)
    assert not cw.fits_wave2d_kernel((H, W), torch.float64, 8)
    assert not cw.fits_wave2d_kernel((4, H, W), torch.float32, 8)
    assert not cw.fits_wave_kernel((H, W), torch.float32, 8)  # the 3-D guard stays 3-D
    assert cw.fits_wave2d_kernel((751, 895), torch.float32, 8)


def _counting(monkeypatch):
    """Count the kernels' launches (here: their plain versions' calls, one per
    launch on a card) and the shape of each result."""
    seen = {"fused_leapfrog_step2d": [], "fused_adjoint_step2d": []}
    for name, plain in (("fused_leapfrog_step2d", PLAIN_K4), ("fused_adjoint_step2d", PLAIN_K5)):
        def launch(*args, _plain=plain, _name=name, **kw):
            out = _plain(*args, **kw)
            seen[_name].append(tuple((out if torch.is_tensor(out) else out[0]).shape))
            return out

        monkeypatch.setattr(cw, name + "_torch", launch)
    return seen


@pytest.mark.parametrize("layout", ["dim0", "dim1", "dim2", "one_shot"])
def test_vmap_rule_is_one_launch_with_the_bits_of_a_loop(layout, monkeypatch):
    """Under ``torch.func.vmap`` each wrapper launches once for the stacked
    shots, whichever dimension holds them (moved to the front) and with
    unbatched operands shared, with the bits of a per-shot loop."""
    seen = _counting(monkeypatch)
    nb = 1 if layout == "one_shot" else B
    d = {"dim0": 0, "dim1": 1, "dim2": 2, "one_shot": 0}[layout]
    up, u, a1, a2, gc2 = (x[:nb] for x in _fields(5, 50))
    c2, S, src = _c2(51)[:nb], _sponge(), _src()[:nb]
    q = (60 * a2).to(torch.int8)
    sc = torch.linspace(0.01, 0.03, nb)
    s_t, amp = torch.tensor(0.25), torch.tensor(3e-3)

    def moved(x):
        return x.movedim(0, d).contiguous() if d else x

    fwd = torch.func.vmap(lambda a, b_, s: cw.fused_leapfrog_step2d(a, b_, c2[0], S, s_t, s,
                                                                    amp, order=8),
                          in_dims=(d, 0, 0))(moved(up), u, src)
    core, g = torch.func.vmap(
        lambda x, y, z, qq, ss: cw.fused_adjoint_step2d(x, y, z, c2[0], qq, ss, S, order=4),
        in_dims=(0, d, 0, d, 0))(a1, moved(a2), gc2, moved(q), sc)
    assert seen == {"fused_leapfrog_step2d": [(nb, H, W)], "fused_adjoint_step2d": [(nb, H, W)]}
    for b in range(nb):
        ref = PLAIN_K4(up[b], u[b], c2[0], S, s_t, src[b], amp, order=8)
        assert torch.equal(fwd[b], ref)
        cr, gr = PLAIN_K5(a1[b], a2[b], gc2[b], c2[0], q[b], sc[b], S,
                                               order=4)
        assert torch.equal(core[b], cr) and torch.equal(g[b], gr)
    assert float(fwd.abs().max()) > 0.0 and float(g.abs().max()) > 0.0


def test_jvp_tangent_is_the_plain_steps(monkeypatch):
    """``torch.func.jvp`` through K4-2D, alone and around a ``vmap`` of it
    (functorch's own dispatch of the rule, one launch for the batch), gives
    the plain step's primal and tangent bit for bit, with tangents of the
    fields and c²dt² and of every input."""
    seen = _counting(monkeypatch)
    up, u, dup, du = _fields(4, 60)
    c2, dc2, S = _c2(61), _c2(62), _sponge()
    src, s_t, amp = _src(), torch.tensor(0.4), torch.tensor(2e-3)

    def kern(a, b_, c):
        return cw.fused_leapfrog_step2d(a, b_, c, S, s_t, src, amp, order=8)

    def plain(a, b_, c):
        return PLAIN_K4(a, b_, c, S, s_t, src, amp, order=8)

    for tang in ((dup, du, dc2), (torch.zeros_like(up), du, torch.zeros_like(c2)),
                 (torch.zeros_like(up), torch.zeros_like(u), dc2)):
        yk, jk = torch.func.jvp(kern, (up, u, c2), tang)
        yp, jp = torch.func.jvp(plain, (up, u, c2), tang)
        assert torch.equal(yk, yp) and torch.equal(jk, jp) and float(jp.abs().max()) > 0.0
    yv, jv = torch.func.jvp(
        lambda a, b_, c: torch.func.vmap(
            lambda x, y, z, s: cw.fused_leapfrog_step2d(x, y, z, S, s_t, s, amp, order=8))(
            a, b_, c, src), (up, u, c2), (dup, du, dc2))
    yp, jp = torch.func.jvp(plain, (up, u, c2), (dup, du, dc2))
    assert torch.equal(yv, yp) and torch.equal(jv, jp)
    assert [s for s in seen["fused_leapfrog_step2d"] if len(s) == 3]
    dS = 0.01 * _fields(1, 63, (H, W))[0]
    every = ((up, u, c2, S, s_t, amp), (dup, du, dc2, dS, torch.tensor(0.3),
                                         torch.tensor(-1e-3)))
    yk, jk = torch.func.jvp(
        lambda a, b_, c, s, t, m: cw.fused_leapfrog_step2d(a, b_, c, s, t, src, m, order=8),
        *every)
    yp, jp = torch.func.jvp(
        lambda a, b_, c, s, t, m: PLAIN_K4(a, b_, c, s, t, src, m,
                                                                 order=8), *every)
    assert torch.equal(yk, yp) and torch.equal(jk, jp)


@pytest.mark.parametrize("transform", ["jvp", "grad", "nested_vmap"])
def test_adjoint_pair_refuses_every_transform_but_one_vmap(transform):
    """K5-2D has no tangent and no backward, and nested vmaps are not its
    batching: under any transform but one ``vmap`` level it raises (the
    stored adjoint takes the plain reverse step there)."""
    a1, a2, gc2 = _fields(3, 80)
    c2, S = _c2(81), _sponge()
    q, sc = (60 * a2).to(torch.int8), torch.linspace(0.01, 0.03, B)

    def step(x):
        return cw.fused_adjoint_step2d(x, a2, gc2, c2, q, sc, S, order=8)[1].sum()

    with pytest.raises(ValueError, match="one vmap level"):
        if transform == "jvp":
            torch.func.jvp(step, (a1,), (torch.ones_like(a1),))
        elif transform == "grad":
            torch.func.grad(step)(a1)
        else:
            torch.func.vmap(torch.func.vmap(step))(a1[None].expand(2, B, H, W))


SHAPE2 = (24, 28)
KW2 = dict(nt=30, dt=1e-3, dx=10.0, freq=18.0, src_idx=12 * 28 + 13, sponge_width=4)


def _velocity(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((1500.0 + 30.0 * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("store", [None, "f32", "bf16", "int8"])
@pytest.mark.parametrize("order", [2, 8])
def test_fused_true_on_a_2d_grid_is_the_plain_route(order, store, monkeypatch):
    """``fused=True`` on a 2-D CPU grid runs the pair through the wrappers'
    plain versions (forward in place, stored sweeps), bit for bit
    ``fused=False``'s traces, Born forward (jvp) and adjoints; a tape (the
    derived adjoint) takes the plain step; nothing is launched."""
    seen = _counting(monkeypatch)
    c, dc = _velocity(SHAPE2, order), _velocity(SHAPE2, 7) - 1500.0
    Fk = tw.wave_propagator(SHAPE2, fused=True, store_adjoint=store, space_order=order,
                            device=CPU, **KW2)
    Fp = tw.wave_propagator(SHAPE2, fused=False, store_adjoint=store, space_order=order,
                            device=CPU, **KW2)
    cw.reset_launch_counts()
    yk, yp = Fk(c), Fp(c)
    assert torch.equal(yk, yp) and float(yp.abs().max()) > 0.0
    d = _fields(1, 8, yp.shape)[0]
    assert torch.equal(Fk.linearize(c).H(d), Fp.linearize(c).H(d))
    assert torch.equal(Fk.linearize(c)(dc), Fp.linearize(c)(dc))
    nt = KW2["nt"]
    # the forward, the stored adjoint's history sweep (a derived adjoint's tape
    # runs the plain step) and the Born forward
    want_fwd = nt * (2 if store is None else 3)
    assert len(seen["fused_leapfrog_step2d"]) == want_fwd
    assert len(seen["fused_adjoint_step2d"]) == (0 if store is None else nt)
    assert cw.launch_counts() == ZERO


def _pair_on_cpu(monkeypatch):
    """``fused=None`` takes the 2-D pair on CPU tensors, as on a card, where
    the caller has it; the launchers' calls counted."""
    orig = tw._kernel_route

    def route(fused, c, sponge, order, refuse=None, pair2d=False):
        if fused is None and pair2d and len(c.shape) == 2 and refuse is None:
            fused = True
        return orig(fused, c, sponge, order, refuse, pair2d)

    monkeypatch.setattr(tw, "_kernel_route", route)
    return _counting(monkeypatch)


def _stack(store, windows, **kw):
    grid = (30, 40)
    srcs = [5 * 40 + 5, 9 * 40 + 20, 4 * 40 + 33]
    extra = dict(window_shape=(30, 24), window_corners=[[0, 0], [0, 8], [0, 16]]) \
        if windows else {}
    return grid, tw.multishot_wave_operator(
        grid, srcs, nt=25, dt=1e-3, dx=10.0, freq=18.0, sponge_width=4, space_order=8,
        store_adjoint=store, free_surface=True, device=CPU, **extra, **kw)


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("store", [None, "int8"])
def test_vmap_stack_on_the_pair_is_the_plain_route(store, windows, monkeypatch):
    """The 2-D ``"vmap"`` stack on the pair (one launch a step for the 3
    shots): ``f``, the stored int8 adjoint, the Born forward (jvp) and the
    derived adjoint (its tape takes the plain step), bit for bit the plain
    route's."""
    grid, Fp = _stack(store, windows)
    c = _velocity(grid, 70)
    dc = _velocity(grid, 71) - 1500.0
    yp = Fp(c)
    d = _fields(1, 72, yp.shape)[0]
    gp, jp = Fp.linearize(c).H(d), Fp.linearize(c)(dc)
    seen = _pair_on_cpu(monkeypatch)
    _, Fk = _stack(store, windows)
    assert torch.equal(Fk(c), yp)
    assert [len(s) for s in seen["fused_leapfrog_step2d"]] == [3] * 25
    assert torch.equal(Fk.linearize(c).H(d), gp) and float(gp.abs().max()) > 0.0
    assert torch.equal(Fk.linearize(c)(dc), jp)
    n_fwd, n_adj = len(seen["fused_leapfrog_step2d"]), len(seen["fused_adjoint_step2d"])
    # f, the stored adjoint's history sweep (the derived adjoint's tape runs the
    # plain step) and the Born forward; the reverse sweep
    assert (n_fwd, n_adj) == ((25 * 2, 0) if store is None else (25 * 3, 25))


@pytest.mark.parametrize("wrt", ["m0", "d"])
def test_stored_adjoint_under_a_tape_is_the_plain_route(wrt, monkeypatch):
    """A tape on the model or the data of the windowed 2-D ``"vmap"`` stack's
    stored adjoint, which the batched tensors inside the ``vmap`` do not
    show, takes the plain sweeps: the adjoint's own gradient by autograd is
    bit for bit the plain route's, and no reverse step rides the pair."""
    grid, Fp = _stack("int8", True)
    c = _velocity(grid, 73)
    d = _fields(1, 74, Fp(c).shape)[0]
    v = _fields(1, 75, grid)[0]

    def second(F):
        x = (c if wrt == "m0" else d).clone().requires_grad_()
        g = F.linearize(x if wrt == "m0" else c).H(d if wrt == "m0" else x)
        return torch.autograd.grad((g * v).sum(), x)[0]

    ref = second(Fp)
    seen = _pair_on_cpu(monkeypatch)
    _, Fk = _stack("int8", True)
    assert torch.equal(second(Fk), ref) and float(ref.abs().max()) > 0.0
    assert seen["fused_adjoint_step2d"] == []


def test_3d_vmap_stack_stays_plain(monkeypatch):
    """A 3-D ``"vmap"`` stack keeps ``fused=False`` (the 3-D kernels do not
    batch): no kernel wrapper runs, even where ``fused=None`` would take the
    pair."""
    seen = _pair_on_cpu(monkeypatch)
    calls = []
    for name in ("fused_leapfrog_step", "fused_adjoint_step"):
        orig = getattr(cw, name)
        monkeypatch.setattr(cw, name, lambda *a, _o=orig, **k: calls.append(1) or _o(*a, **k))
    F = tw.multishot_wave_operator((12, 8, 40), [4 * 320 + 20, 6 * 320 + 100], nt=8,
                                   store_adjoint="int8", device=CPU)
    c = torch.full((12, 8, 40), 1500.0)
    y = F(c)
    g = F.linearize(c).H(y)
    assert float(g.abs().max()) > 0.0
    assert not calls and seen == {"fused_leapfrog_step2d": [], "fused_adjoint_step2d": []}


def _other_physics():
    grid, srcs = (20, 24), [5 * 24 + 5, 9 * 24 + 14]
    kw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3, device=CPU)
    m1 = torch.full(grid, 1500.0)
    return {
        "vti": (lambda: tt.ops.wave.multishot_vti_wave_operator(grid, srcs, store_adjoint="int8",
                                                                **kw),
                lambda F: tt.BlockVector((m1, torch.full(grid, 0.1), torch.full(grid, 0.05)),
                                         F.dom)),
        "tti": (lambda: tt.ops.wave.multishot_tti_wave_operator(grid, srcs, **kw),
                lambda F: tt.BlockVector((m1, torch.full(grid, 0.1), torch.full(grid, 0.05),
                                          torch.full(grid, 0.3)), F.dom)),
        "cpml": (lambda: tw.multishot_wave_operator(grid, srcs, boundary="cpml", **kw),
                 lambda F: m1),
        "vd": (lambda: tw.vd_wave_propagator(grid, src_idx=srcs[0], store_adjoint="int8",
                                             **kw),
               lambda F: tt.BlockVector((m1, torch.full(grid, 1e-3)), F.dom)),
        "q": (lambda: tw.q_wave_propagator(grid, src_idx=srcs[0], store_adjoint="int8", **kw),
              lambda F: tt.BlockVector((m1, torch.full(grid, 40.0)), F.dom)),
        "offgrid": (lambda: tw.offgrid_wave_propagator(
            grid, src_pos=(4.5, 10.25), rcv_depth=3.5, rcv_coords=np.linspace(2.0, 20.0, 7),
            store_adjoint="int8", **kw), lambda F: m1),
    }


@pytest.mark.parametrize("kind", ["vti", "tti", "cpml", "vd", "q", "offgrid"])
def test_other_2d_physics_keep_their_plain_steps(kind, monkeypatch):
    """The 2-D VTI, TTI, CPML, variable-density, Q and off-grid propagators
    (the three stacks in ``"vmap"`` mode) never reach the pair, even where
    ``fused=None`` would take it: bit for bit, forward and adjoint."""
    make, model = _other_physics()[kind]
    F = make()
    m = model(F)
    y = F(m)
    g = F.linearize(m).H(y)
    seen = _pair_on_cpu(monkeypatch)
    F2 = make()
    assert torch.equal(F2(m), y)
    g2 = F2.linearize(m).H(y)
    for a, b in zip(g2.blocks if hasattr(g2, "blocks") else (g2,),
                    g.blocks if hasattr(g, "blocks") else (g,)):
        assert torch.equal(a, b)
    assert seen == {"fused_leapfrog_step2d": [], "fused_adjoint_step2d": []}
    assert float(y.abs().max()) > 0.0
