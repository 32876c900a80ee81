"""``remat_blocks > 1`` under ``shot_map="vmap"`` (jets_tpu_torch/ops/wave.py,
``_Segment`` and ``_multishot_operator``), held against ``remat_blocks=1``
and against jets_tpu's vmap-mode stacks on the CPU, on the same numpy
inputs.

Each case builds the iso (with and without Ginsu windows, and with CPML
boundaries), VTI and TTI (2-D and 3-D) vmap stacks in float64 at 1 and 4
segments. Within the port, segments change memory, not values: the
traces, the autograd gradient of ``0.5‖F(m) − d‖²`` and the derived
adjoint ``F.linearize(m).H(r)`` are the same bits at 1 and 4 segments (and
the derived adjoint and ``torch.func.vjp`` of the stack are the autograd
gradient, bit for bit, at ``r = F(m) − d``). The memory is what segments
give: the bytes the forward saves for the backward, counted through
``saved_tensors_hooks`` (distinct storages), fall to at most half at 4 segments, in the
autograd gradient and in the derived adjoint, which run through 4
``_Segment``s, as ``torch.func.vjp`` does (the stack sees the tape
outside ``vmap``). Against JAX (``lax.scan`` under ``jax.checkpoint``,
compiled, FMA-contracted, where the port runs eagerly) the traces agree,
and the gradient and the derived adjoint agree with JAX's vjp at the same
residual, to ``rtol=1e-9`` of their peak. Every
comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
F64 = torch.float64
RTOL_JAX = 1e-9

G2 = (20, 24)
K2 = dict(nt=24, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3)
SRC2 = [24 * 6 + 6, 24 * 13 + 15]
G3 = (6, 8, 16)
K3 = dict(nt=16, dt=6e-4, dx=10.0, freq=16.0, sponge_width=2,
          rcv_idx=[int(np.ravel_multi_index((3, 4, x), G3)) for x in range(16)])
SRC3 = [int(np.ravel_multi_index((3, 4, 6), G3)), int(np.ravel_multi_index((3, 4, 10), G3))]
WGRID, WIN = (24, 24), (12, 12)
CORNERS = np.array([[0, 0], [12, 12]])

# name: (JAX constructor, port constructor, grid, sources, keywords, model means)
CASES = {
    "iso": (jw.multishot_wave_operator, tw.multishot_wave_operator, G2, SRC2, K2, ()),
    "iso-windows": (jw.multishot_wave_operator, tw.multishot_wave_operator, WGRID,
                    [12 * 6 + 6] * 2,
                    dict(K2, rcv_idx=np.arange(0, 144, 3), window_shape=WIN,
                         window_corners=CORNERS), ()),
    # CPML carries six fields, so its segments need more steps to save memory
    "iso-cpml": (jw.multishot_wave_operator, tw.multishot_wave_operator, G2, SRC2,
                 dict(K2, nt=72, boundary="cpml", cmax=2500.0), ()),
    "vti": (jw.multishot_vti_wave_operator, tw.multishot_vti_wave_operator, G2, SRC2, K2,
            (0.1, 0.05)),
    "tti-2d": (jw.multishot_tti_wave_operator, tw.multishot_tti_wave_operator, G2, SRC2,
               K2, (0.1, 0.05, 0.3)),
    "tti-3d": (jw.multishot_tti_wave_operator, tw.multishot_tti_wave_operator, G3, SRC3,
               K3, (0.1, 0.05, 0.3, 0.7)),
}


def _live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, "vacuous: signal is zero"


def _close(got, ref, rtol=RTOL_JAX):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))))


def _carried(Ft, Fj):
    """The port stack on the JAX stack's wavelet (and sponge)."""
    ss = Fj.jet.state["sstate"]
    if "sponge" not in ss:  # CPML: the profiles are bitwise equal already
        return tt.with_state(Ft, sstate={**Ft.jet.state["sstate"],
                                         "wavelet": torch.from_numpy(
                                             np.array(ss["wavelet"]))})
    sp = ss["sponge"]
    return tw.with_wave_arrays(
        Ft, wavelet=ss["wavelet"],
        sponge=tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else np.asarray(sp),
        src_idx=Fj.jet.state["bstate"]["src"], rcv_idx=ss["rcv"])


def _model(grid, means, seed):
    rng = np.random.default_rng(seed)
    blocks = [1500.0 + 20.0 * rng.standard_normal(grid)]
    blocks += [v + 0.1 * v * rng.standard_normal(grid) for v in means]
    return blocks


def _jax_model(Fj, blocks):
    if len(blocks) == 1:
        return jnp.asarray(blocks[0])
    m = Fj.dom.zeros()
    for i, b in enumerate(blocks):
        m = m.setblock(i, jnp.asarray(b))
    return m


def _jax_leaves(x, n):
    return [np.asarray(x)] if n == 1 else [np.asarray(x.getblock(i)) for i in range(n)]


def _port_model(F, leaves):
    return leaves[0] if len(leaves) == 1 else tt.BlockVector(leaves, F.dom)


class _Saved:
    """Bytes of the distinct storages saved for the backward while the hooks
    are entered (a tensor saved twice, or a view of one saved, counts once)."""

    def __init__(self):
        self.storages = {}

    @property
    def nbytes(self):
        return sum(self.storages.values())

    def hooks(self):
        def pack(t):
            st = t.untyped_storage()
            self.storages[st.data_ptr()] = st.nbytes()
            return t

        return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def _run(F, blocks, d_obs, monkeypatch):
    """Traces, autograd gradient and derived adjoint of the port stack ``F``,
    with the bytes each forward saved and the number of segments each ran."""
    segments = []
    real_forward = tw._Segment.forward

    def counted(*args):
        segments.append(1)
        return real_forward(*args)

    monkeypatch.setattr(tw._Segment, "forward", staticmethod(counted))
    grad_saved, adj_saved = _Saved(), _Saved()
    leaves = [torch.from_numpy(np.array(b)).requires_grad_() for b in blocks]
    with grad_saved.hooks():
        d = F(_port_model(F, leaves))
    r = d - d_obs
    grads = torch.autograd.grad(0.5 * torch.sum(r * r), leaves)
    n_grad = len(segments)
    real_vjp = tw._vjp_by_autograd

    def vjp_counting_its_forward(fn, m0, dd):
        def fwd(m):
            with adj_saved.hooks():
                return fn(m)

        return real_vjp(fwd, m0, dd)

    monkeypatch.setattr(tw, "_vjp_by_autograd", vjp_counting_its_forward)
    m0 = _port_model(F, [b.detach() for b in leaves])
    adj = pytree.tree_leaves(F.linearize(m0).H(r.detach()))
    n_adj = len(segments) - n_grad
    _, pull = torch.func.vjp(F, m0)  # the stack sees torch.func.vjp's tracking too
    fvjp = pytree.tree_leaves(pull(r.detach())[0])
    monkeypatch.undo()
    return (d.detach(), grads, adj, fvjp, grad_saved.nbytes, adj_saved.nbytes,
            (n_grad, n_adj, len(segments) - n_grad - n_adj))


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_segments_are_the_same_bits_with_less_memory_and_match_jax(case,
                                                                        monkeypatch):
    jctor, tctor, grid, srcs, kw, means = CASES[case]
    Fj = jctor(grid, np.asarray(srcs), remat_blocks=4, dtype=jnp.float64, **kw)
    blocks = _model(grid, means, seed=len(case))
    mj = _jax_model(Fj, blocks)
    dj, pull = jax.vjp(Fj, mj)
    noise = np.random.default_rng(7).standard_normal(dj.shape)
    d_obs_np = 0.9 * np.asarray(dj) + 0.1 * float(jnp.max(jnp.abs(dj))) * noise
    d_obs = torch.from_numpy(d_obs_np)
    runs = {}
    for rb in (1, 4):
        Ft = _carried(tctor(grid, srcs, remat_blocks=rb, shot_map="vmap", dtype=F64,
                            device=CPU, **kw), Fj)
        runs[rb] = _run(Ft, blocks, d_obs, monkeypatch)
    (d1, g1, a1, f1, sg1, sa1, n1), (d4, g4, a4, f4, sg4, sa4, n4) = runs[1], runs[4]
    # the same bits at 1 and 4 segments; the derived adjoint and
    # torch.func.vjp of the stack are the gradient
    _live(d1.numpy())
    assert torch.equal(d1, d4)
    for x1, x4, y1, y4, z1, z4 in zip(g1, g4, a1, a4, f1, f4):
        _live(x1.numpy())
        assert torch.equal(x1, x4) and torch.equal(y1, y4) and torch.equal(x1, y1)
        assert torch.equal(z1, x1) and torch.equal(z4, x1)
    # the memory: 4 segments in every route, at most half the saved bytes
    assert n1 == (0, 0, 0) and n4 == (4, 4, 4), (n1, n4)
    assert 2 * sg4 < sg1 and 2 * sa4 < sa1, (sg1, sg4, sa1, sa4)
    # JAX's vmap stack with 4 segments: its traces and its vjp at F(m) − d
    _close(d4.numpy(), dj)
    (gj,) = pull(dj - jnp.asarray(d_obs_np))
    for x, y, xj in zip(g4, a4, _jax_leaves(gj, len(blocks))):
        _close(x.numpy(), xj)
        _close(y.numpy(), xj)
