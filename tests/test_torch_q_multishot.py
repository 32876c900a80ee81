"""``multishot_q_wave_operator``: constant-Q visco-acoustic modelling of
many shots on a ``(c, Q)`` model, each shot in its Ginsu window of both
blocks, held against the single-shot ``q_wave_propagator`` on that shot's
windowed model and against ``multishot_wave_operator`` at Q = ∞, with the
port's own gates. Small grids on the CPU (the plain steps; K14 rides the
same sweeps on a card): a 20 × 40 × 40 model, 16 × 24 × 24 windows, two
shots, order 8, a free surface, nt 60, an int8 history.

Tolerances: the traces are the single-shot operator's bit for bit (the
same sweep on the same window); the stored-history gradient is the
scatter-added single-shot gradients bit for bit (each window's pair is
placed into its own zero grid and the two grids are added, as the sum
here adds them); the vmapped stack agrees with the map stack to
``rtol=1e-6`` of the peak (the batched plain ops round alike, the shots'
sum may not). Every comparison has a live-signal guard.
"""
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.utils import profiling

CPU = torch.device("cpu")
GRID, WIN = (20, 40, 40), (16, 24, 24)
CORNERS = [[0, 2, 3], [4, 14, 10]]
SRCS = [int(np.ravel_multi_index(p, WIN)) for p in ((2, 12, 12), (2, 9, 15))]
RCV = [int(np.ravel_multi_index((2, y, x), WIN))
       for y in range(0, 24, 3) for x in range(0, 24, 3)]
KW = dict(nt=60, dt=1.5e-3, dx=25.0, freq=8.0, rcv_idx=RCV, sponge_width=4, space_order=8,
          free_surface=True, device=CPU)
WKW = dict(KW, window_corners=CORNERS, window_shape=WIN)


def _live(x):
    assert float(torch.max(torch.abs(x))) > 0.0, "vacuous: zero signal"


def model(seed, dtype=torch.float32, shape=GRID):
    """A velocity field of 2.2–6.0 km/s and Q from the benchmark's law."""
    g = torch.Generator().manual_seed(seed)
    c = (2200.0 + 3800.0 * torch.rand(shape, generator=g, dtype=torch.float64))
    return c.to(dtype), (14.0 * (c / 1000.0) ** 2.2).to(dtype)


def window(x, i):
    return x[tuple(slice(a, a + n) for a, n in zip(CORNERS[i], WIN))]


def single(i, **extra):
    return tw.q_wave_propagator(WIN, src_idx=SRCS[i], **dict(KW, **extra))


@pytest.fixture
def spans_on():
    was = profiling.set_spans(True)
    profiling.spans(reset=True)
    yield
    profiling.set_spans(was)
    profiling.spans(reset=True)


@pytest.mark.parametrize("coeff_dtype", [None, torch.bfloat16])
def test_traces_and_gradient_are_the_single_shot_operators(coeff_dtype):
    """With either friction width: ``coeff_dtype=torch.bfloat16`` rounds
    every window's friction field as the single-shot operator rounds it."""
    c, q = model(0)
    F = tw.multishot_q_wave_operator(GRID, SRCS, shot_map="map", store_adjoint="int8",
                                     coeff_dtype=coeff_dtype, **WKW)
    m = tt.BlockVector((c, q), F.dom)
    d = F(m)
    assert d.shape == (2, 60, len(RCV))
    if coeff_dtype is not None:  # the rounding moves the traces
        assert not torch.equal(d, tw.multishot_q_wave_operator(GRID, SRCS, shot_map="map",
                                                               **WKW)(m))
    r = d - F(tt.BlockVector((c * 1.02, q), F.dom))
    g = F.linearize(m).H(r)
    want = [torch.zeros(GRID), torch.zeros(GRID)]
    for i in range(2):
        Fi = single(i, store_adjoint="int8", coeff_dtype=coeff_dtype)
        mi = tt.BlockVector((window(c, i), window(q, i)), Fi.dom)
        _live(d[i])
        assert torch.equal(d[i], Fi(mi))
        placed = [torch.zeros(GRID), torch.zeros(GRID)]
        for b, gb in enumerate(Fi.linearize(mi).H(r[i])):
            window(placed[b], i).copy_(gb)
            want[b] = want[b] + placed[b]
    assert isinstance(g, tt.BlockVector) and g.space == F.dom
    for got, w in zip(g, want):  # (δc, δQ)
        _live(w)
        assert torch.equal(got, w)


def test_q_infinite_is_the_isotropic_multishot_bit_for_bit():
    c, _ = model(1)
    F = tw.multishot_q_wave_operator(GRID, SRCS, shot_map="map", **WKW)
    F0 = tw.multishot_wave_operator(GRID, SRCS, shot_map="map", **WKW)
    d0 = F0(c)
    _live(d0)
    assert torch.equal(F(tt.BlockVector((c, torch.full(GRID, float("inf"))), F.dom)), d0)


@pytest.mark.parametrize("store", [None, "f32"])
def test_gates_in_float64(store):
    """The Jacobian passes the dot-product gate (``rtol=1e-9``, float64)
    with the derived adjoint and with the stored f32 history, windows and
    free surface included, and the linearization gate shows second-order
    decay."""
    c, q = model(2, torch.float64)
    F = tw.multishot_q_wave_operator(GRID, SRCS, shot_map="map", store_adjoint=store,
                                     dtype=torch.float64, **dict(WKW, nt=40))
    m0 = tt.BlockVector((c, q), F.dom)
    J = F.linearize(m0)
    g = torch.Generator().manual_seed(3)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    assert abs(float(rhs)) > 0.0
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    if store is None:
        dm = F.dom.randn(torch.Generator().manual_seed(4))
        dm = tt.BlockVector((50.0 * dm[0], 2.0 * dm[1]), F.dom)
        obs, exp = tt.linearization_test(F, m0, delta_m=dm, mu=(1.0, 0.5, 0.25, 0.125))
        np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_vmap_stack_agrees_with_the_map_stack():
    c, q = model(5)
    Fm, Fv = (tw.multishot_q_wave_operator(GRID, SRCS, shot_map=sm, store_adjoint="f32",
                                           **dict(WKW, nt=30)) for sm in ("map", "vmap"))
    m = tt.BlockVector((c, q), Fm.dom)
    dm, dv = Fm(m), Fv(m)
    _live(dm)
    torch.testing.assert_close(dv, dm, rtol=1e-6, atol=1e-6 * float(dm.abs().max()))
    for a, b in zip(Fv.linearize(m).H(dm), Fm.linearize(m).H(dm)):
        _live(b)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


def test_windowing_on_a_tensor_keeps_its_bits_and_counts():
    take, place = tw._windowing(GRID, WIN, CPU)
    m = torch.randn(GRID, generator=torch.Generator().manual_seed(6))
    g = torch.randn(WIN, generator=torch.Generator().manual_seed(7))
    corner = torch.tensor(CORNERS[1])
    before = profiling.counters(["windows.take", "windows.place"])
    assert torch.equal(take(m, corner), window(m, 1))
    want = torch.zeros(GRID)
    window(want, 1).copy_(g)
    assert torch.equal(place(g, corner), want)
    sp = tt.BlockSpace([tt.Space(GRID, device=CPU)] * 2)
    wsp = tt.BlockSpace([tt.Space(WIN, device=CPU)] * 2)
    btake, bplace = tw._windowing(GRID, WIN, CPU, (sp, wsp))
    bw = btake(tt.BlockVector((m, 2.0 * m), sp), corner)
    assert bw.space == wsp and torch.equal(bw[1], 2.0 * window(m, 1))
    bg = bplace(tt.BlockVector((g, g), wsp), corner)
    assert bg.space == sp and torch.equal(bg[0], want) and torch.equal(bg[1], want)
    after = profiling.counters(["windows.take", "windows.place"])
    assert {k: after[k] - before[k] for k in after} == {"windows.take": 2, "windows.place": 2}


def test_sweeps_count_their_steps_in_spans(spans_on):
    c, q = model(8)
    F = tw.multishot_q_wave_operator(GRID, SRCS, shot_map="map", store_adjoint="int8",
                                     **dict(WKW, nt=20))
    m = tt.BlockVector((c, q), F.dom)
    before = profiling.counters(["steps.history", "steps.reverse"])
    F.linearize(m).H(F(m))
    after = profiling.counters(["steps.history", "steps.reverse"])
    assert {k: after[k] - before[k] for k in after} == {"steps.history": 40,
                                                      "steps.reverse": 40}
    sweeps = [s for s in profiling.spans() if s["name"] in ("sweep.history", "sweep.reverse")]
    assert len(sweeps) == 4 and all(s["attrs"] == {"physics": "q"} for s in sweeps)
    names = {s["name"] for s in profiling.spans()}
    assert {"multishot.f", "multishot.adjoint", "shot", "window.take", "window.place",
            "codec.encode", "sweep.forward"} <= names


def test_free_surface_and_refusals():
    c, q = model(9, shape=WIN)
    m = tt.BlockVector((c, q), single(0).dom)
    assert not torch.equal(single(0)(m), single(0, free_surface=False)(m))
    with pytest.raises(ValueError, match="out of bounds"):
        tw.multishot_q_wave_operator(GRID, SRCS, **dict(WKW, window_corners=[[0, 0, 0],
                                                                             [5, 0, 0]]))
    with pytest.raises(ValueError, match="coeff_dtype"):
        tw.multishot_q_wave_operator(GRID, SRCS, coeff_dtype=torch.float16, **WKW)
    assert tt.multishot_q_wave_operator is tw.multishot_q_wave_operator
    assert tt.ops.multishot_q_wave_operator is tw.multishot_q_wave_operator
