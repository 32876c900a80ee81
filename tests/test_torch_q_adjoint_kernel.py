"""K15, the reverse constant-Q step of the stored-history (c, Q) adjoint
(``cuda_wave.fused_q_adjoint_step``), on the CPU: its plain twin
(``fused_q_adjoint_step_torch``, through the wrapper) driven over whole
reverse sweeps of ``ops/wave._adjoint_stored_q`` against that sweep as it
was written before the kernel (kept below as ``sweep_before``: the carried
``ē_{k+1}``, ``sē_{k+1}`` in place of the ``(a_{k+1}, a_{k+2})`` state),
bit for bit; the wrapper's refusals and its in-place contract; and the
route: a 3-D float32 grid with ``fused=True`` takes K15 (here its twin),
while ``fused=False``, a 2-D grid and a call whose autograd tape records
``c``, ``Q`` or ``dd`` reverse with the plain step, also bit for bit.

The CUDA kernel runs only on a card, where ``chip_smoke.py`` (phase 72)
holds it bitwise against the twin tested here.
"""
import numpy as np
import pytest
import torch

from jets_tpu_torch.ops import cuda_wave as cw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")
SHAPE = (11, 13, 37)  # no dimension a whole number of K15's tiles or z-chunks
NT = 14
SRC = int(np.ravel_multi_index((3, 6, 18), SHAPE))
RCV = torch.tensor([int(np.ravel_multi_index((2, 6, x), SHAPE)) for x in range(0, 37, 3)])
KW = dict(dt=1.5e-3, dx=25.0, f0=8.0)


def _live(x):
    assert float(torch.max(torch.abs(x))) > 0.0, "vacuous: zero signal"


def _inputs(seed, shape=SHAPE, dtype=torch.float32):
    """``(c, Q, dd, wavelet, sponge)``: 2.2–6.0 km/s, Q of the benchmark's
    law, residual traces, a Ricker wavelet and the free-surface sponge
    (per-axis factors in 3-D, the full grid in 2-D)."""
    g = torch.Generator().manual_seed(seed)
    c = 2200.0 + 3800.0 * torch.rand(shape, generator=g, dtype=torch.float64)
    q = 14.0 * (c / 1000.0) ** 2.2
    dd = torch.randn((NT, len(RCV)), generator=g, dtype=torch.float64)
    wav = tw._ricker(NT, KW["dt"], 8.0)
    sponge = tw._make_sponge(shape, 3, free_surface=True)
    return c.to(dtype), q.to(dtype), dd.to(dtype), wav.to(dtype), sponge


def sweep_before(c, qf, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, f0, sponge,
                 order=2, store="int8", coeff16=False):
    """``_adjoint_stored_q``'s plain route before K15, line for line."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    nt = int(src_wavelet.shape[0])
    C = tw._c2dt2(c, dt, dx)
    g_raw = tw._q_friction(qf, dt, f0)
    g = tw._r16(g_raw) if coeff16 else g_raw
    ig, og = 1.0 / (1.0 + g), 1.0 - g
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    enc, dec = tw._store_codec(store, dtype)
    dd = dd.to(dtype)
    S = tw._sponge_full(sponge)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)

    mask = cw.source_mask(shape, src_idx, amp)
    hist = []
    u_prev, u = zeros(), zeros()
    for k in range(nt):
        hist.append(enc(u))
        u_next = cw.q_plain(u_prev, u, C, og, ig, S, src_wavelet[k], mask, order)
        u_prev, u = u, u_next
    a_nxt = zeros().reshape(-1).index_add(0, rcv_idx, dd[-1]).reshape(shape)
    ebar_nxt, sbar_nxt, gC, gig, gog = (zeros() for _ in range(5))
    for k in range(nt - 1, -1, -1):
        u_k = dec(*hist[k])
        sbar = a_nxt * S
        ebar = ig * sbar
        lap_k = tw._laplacian(u_k, order=order)
        gC = gC + lap_k * ebar
        gig = gig + (sbar * (2.0 * u_k + C * lap_k) - og * (u_k * sbar_nxt))
        gog = gog - u_k * ebar_nxt
        a_nxt = (2.0 * ebar + tw._laplacian(C * ebar, order=order)) - og * ebar_nxt
        if k > 0:
            a_nxt.reshape(-1).index_add_(0, rcv_idx, dd[k - 1])
        ebar_nxt, sbar_nxt = ebar, sbar
    gc = gC * (2.0 * c) * torch.tensor((dt * dt) / (dx * dx), dtype=dtype, device=dev)
    gg = -gog - (ig * ig) * gig
    return gc, -gg * (g_raw / qf)


@pytest.fixture
def k15_calls(monkeypatch):
    """Counts the wrapper's calls and its twin's (on the CPU the wrapper
    runs the twin: a call is what a launch is on the card)."""
    calls = {"wrapper": 0, "twin": 0}
    wrapper, twin = cw.fused_q_adjoint_step, cw.fused_q_adjoint_step_torch

    def counted_wrapper(*a, **k):
        calls["wrapper"] += 1
        return wrapper(*a, **k)

    def counted_twin(*a, **k):
        calls["twin"] += 1
        return twin(*a, **k)

    monkeypatch.setattr(cw, "fused_q_adjoint_step", counted_wrapper)
    monkeypatch.setattr(cw, "fused_q_adjoint_step_torch", counted_twin)
    return calls


@pytest.mark.parametrize("coeff16", [False, True], ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_twin_sweep_is_the_sweep_before_k15(order, store, coeff16, k15_calls):
    """Both routes of ``_adjoint_stored_q``, the twin's (``fused=True``) and
    the plain step's, give the (gc, gQ) of the sweep as it was, bitwise;
    the twin ran once a reverse step."""
    c, q, dd, wav, sponge = _inputs(order)
    want = sweep_before(c, q, dd, wav, SRC, RCV, sponge=sponge, order=order, store=store,
                        coeff16=coeff16, **KW)
    for fused, n in ((True, NT), (False, 0)):
        k15_calls.update(wrapper=0, twin=0)
        got = tw._adjoint_stored_q(c, q, dd, wav, SRC, RCV, sponge=sponge, order=order,
                                   store=store, fused=fused, coeff16=coeff16, **KW)
        assert k15_calls == {"wrapper": n, "twin": n}, (fused, k15_calls)
        for a, b in zip(got, want):
            _live(b)
            assert torch.equal(a, b), fused


@pytest.mark.parametrize("order", [2, 4, 8])
def test_infinite_q_step_is_the_k5_step(order):
    """At Q = ∞ (g = 0: ``1 − g`` and ``1/(1 + g)`` are exactly 1) the
    twin's core and gC are K5's plain step bit for bit."""
    g = torch.Generator().manual_seed(order)
    a1, a2, gC, gig, gog = (torch.randn(SHAPE, generator=g) for _ in range(5))
    C = 0.3 * torch.rand(SHAPE, generator=g)
    u = torch.randn(SHAPE, generator=g)
    q = torch.round(u * 40.0).clamp(-127, 127).to(torch.int8)
    spz, sy, sx = tw._factors_1d(tw._make_sponge(SHAPE, 3, free_surface=True))
    core, gC_new, _, _ = cw.fused_q_adjoint_step_torch(
        a1, a2, gC, gig, gog, C, torch.zeros(SHAPE), q, torch.tensor(0.02), spz, sy, sx,
        order=order)
    core5, gc5 = cw.fused_adjoint_step_torch(a1, a2, gC, C, q, torch.tensor(0.02), spz, sy,
                                             sx, order=order)
    _live(core5)
    assert torch.equal(core, core5) and torch.equal(gC_new, gc5)


def _operands(gdtype=torch.float32, store=torch.int8):
    g = torch.Generator().manual_seed(7)
    a1, a2, gC, gig, gog = (torch.randn(SHAPE, generator=g) for _ in range(5))
    C = 0.3 * torch.rand(SHAPE, generator=g)
    gf = (0.01 + 0.05 * torch.rand(SHAPE, generator=g)).to(gdtype)
    u = torch.randn(SHAPE, generator=g)
    q = torch.round(u * 40.0).clamp(-127, 127).to(torch.int8) if store == torch.int8 \
        else u.to(store)
    sc = torch.tensor(0.02 if store == torch.int8 else 1.0)
    return [a1, a2, gC, gig, gog, C, gf, q, sc,
            *tw._factors_1d(tw._make_sponge(SHAPE, 3, free_surface=True))]


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_its_twin_fresh_or_in_place(gdtype, store):
    ops = _operands(gdtype, store)
    cw.reset_launch_counts()
    want = cw.fused_q_adjoint_step_torch(*ops, order=8)
    before = [t.clone() for t in ops]
    fresh = cw.fused_q_adjoint_step(*ops, order=8, inplace=False)
    assert all(torch.equal(a, b) for a, b in zip(ops, before)), "an input was written"
    placed = cw.fused_q_adjoint_step(*ops, order=8)
    assert all(p is t for p, t in zip(placed, (ops[1], ops[2], ops[3], ops[4])))
    for f, p, w in zip(fresh, placed, want):
        _live(w)
        assert torch.equal(f, w) and torch.equal(p, w)
    assert cw.launch_counts()["fused_q_adjoint_step"] == 0


def _bad(case):
    """The wrapper's operands with one defect, and what the error says."""
    ops = _operands()
    if case == "float64 field":
        ops[0] = ops[0].double()
        return ops, TypeError, "float32"
    if case == "float16 friction":
        ops[6] = ops[6].half()
        return ops, TypeError, "g must be"
    if case == "float16 history":
        ops[7] = ops[7].to(torch.float16)
        return ops, TypeError, "history must be"
    if case == "friction shape":
        ops[6] = ops[6][:-1].clone()
        return ops, ValueError, "g "
    if case == "history shape":
        ops[7] = ops[7][:, :-1].clone()
        return ops, ValueError, "history "
    if case == "field shape":
        ops[3] = ops[3][:-1].clone()
        return ops, ValueError, "shapes"
    if case == "history device":
        ops[7] = torch.empty(SHAPE, dtype=torch.int8, device="meta")
        return ops, ValueError, "meta"
    if case == "field device":
        ops[2] = torch.empty(SHAPE, device="meta")
        return ops, ValueError, "meta"
    if case == "strided friction":
        ops[6] = ops[6].transpose(1, 2).contiguous().transpose(1, 2)
        return ops, ValueError, "contiguous"
    if case == "strided field":
        ops[4] = ops[4].transpose(0, 2).contiguous().transpose(0, 2)
        return ops, ValueError, "contiguous"
    if case == "shared buffer":
        ops[1] = ops[0]
        return ops, ValueError, "distinct"
    if case == "history is a field":
        ops[7] = ops[2]
        return ops, ValueError, "distinct"
    if case == "sponge factor":
        ops[10] = ops[9]
        return ops, ValueError, "sy must have shape"
    if case == "2-D grid":
        return [t[0] for t in ops[:8]] + ops[8:], ValueError, "D, H, W"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "float64 field", "float16 friction", "float16 history", "friction shape",
    "history shape", "field shape", "history device", "field device", "strided friction",
    "strided field", "shared buffer", "history is a field", "sponge factor", "2-D grid"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    ops, err, match = _bad(case)
    cw.reset_launch_counts()
    with pytest.raises(err, match=match):
        cw.fused_q_adjoint_step(*ops, order=8)
    assert cw.launch_counts()["fused_q_adjoint_step"] == 0


def test_wrapper_refuses_an_order_it_has_no_stencil_for():
    with pytest.raises(ValueError, match="order"):
        cw.fused_q_adjoint_step(*_operands(), order=6)


def _taped(what):
    """``_adjoint_stored_q`` on the kernel route (``fused=True``) while a
    tape records ``what`` (None: nothing)."""
    c, q, dd, wav, sponge = _inputs(3)
    leaves = {"c": c, "Q": q, "dd": dd}
    if what is not None:
        leaves[what] = leaves[what].clone().requires_grad_()
    with torch.enable_grad():
        gc, gq = tw._adjoint_stored_q(leaves["c"], leaves["Q"], leaves["dd"], wav, SRC, RCV,
                                      sponge=sponge, order=4, store="int8", fused=True, **KW)
    return gc.detach(), gq.detach()


@pytest.mark.parametrize("what", ["c", "Q", "dd"])
def test_a_taped_call_reverses_with_the_plain_step(what, k15_calls):
    want = _taped(None)
    assert k15_calls == {"wrapper": NT, "twin": NT}
    k15_calls.update(wrapper=0, twin=0)
    got = _taped(what)
    assert k15_calls == {"wrapper": 0, "twin": 0}, what
    for a, b in zip(got, want):
        _live(b)
        assert torch.equal(a, b)


def test_a_taped_gradient_flows_through_the_plain_reverse_step():
    """The taped call's (gc, gQ) is differentiable in ``dd`` (linear in
    it): ``⟨∂⟨w, gc⟩/∂dd, dd⟩ = ⟨w, gc⟩``."""
    c, q, dd, wav, sponge = _inputs(4, dtype=torch.float64)
    w = torch.randn(SHAPE, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    dd = dd.clone().requires_grad_()
    with torch.enable_grad():
        gc, _ = tw._adjoint_stored_q(c, q, dd, wav, SRC, RCV, sponge=sponge, order=2,
                                     store="f32", fused=False, **KW)
        (gdd,) = torch.autograd.grad(torch.sum(w * gc), dd)
    lhs, rhs = float(torch.sum(gdd * dd.detach())), float(torch.sum(w * gc.detach()))
    _live(torch.tensor(rhs))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_a_2d_grid_reverses_with_the_plain_step(store, k15_calls):
    shape = (15, 41)
    c, q, dd, wav, sponge = _inputs(0, shape)
    args = (c, q, dd, wav, 3 * 41 + 6, 2 * 41 + torch.arange(0, 37, 3))
    with pytest.raises(ValueError, match="fused"):
        tw._adjoint_stored_q(*args, sponge=sponge, order=8, store=store, fused=True, **KW)
    got = tw._adjoint_stored_q(*args, sponge=sponge, order=8, store=store, **KW)
    assert k15_calls == {"wrapper": 0, "twin": 0}
    want = sweep_before(*args, sponge=sponge, order=8, store=store, **KW)
    for a, b in zip(got, want):
        _live(b)
        assert torch.equal(a, b)

