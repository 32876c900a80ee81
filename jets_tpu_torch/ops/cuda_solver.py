"""Hand-written CUDA kernels of the Krylov solver tails (counterpart of
``jets_tpu/ops/pallas_solver.py``), with their plain PyTorch versions.

=====================  ==========================================  ========
wrapper                replaces (TPU kernel)                       plain
=====================  ==========================================  ========
:func:`xw_update`      ``pallas_solver.xw_update`` (K1)            :func:`xw_update_torch`
:func:`lap3d_axpy_norm2` ``pallas_solver.lap3d_axpy_norm2`` (K2)   :func:`lap3d_axpy_norm2_torch`
:func:`laplacian3d`    ``pallas_solver.laplacian3d`` (K3)          :func:`laplacian3d_torch`
:func:`cg_update`      ``pallas_solver.cg_update`` (K6a)           :func:`cg_update_torch`
:func:`p_update`       ``pallas_solver.p_update`` (K6b)            :func:`p_update_torch`
:func:`lsmr_update`    ``pallas_solver.lsmr_update`` (K7)          :func:`lsmr_update_torch`
=====================  ==========================================  ========

The kernels live in ``csrc/solver_kernels.cu`` (design notes there) and
are built by :mod:`jets_tpu_torch.kernels`. Each wrapper checks device,
dtype (float32), shape and contiguity and raises on anything its kernel
does not take. For a tensor on the CPU it calls the plain version; for a
CUDA tensor it launches the kernel or raises — there is no fallback. Each
wrapper counts its kernel launches in the counter ``launches.<wrapper>`` of
:mod:`~jets_tpu_torch.utils.profiling` (``launch_counts()`` is a view of
them), so a run can show that its main path went through the kernel.

On the card the kernels are bitwise equal to their plain versions (no FMA
contraction; the stencil keeps ``laplacian_nd``'s add order), except the
norm of K2 and the ``rho`` of K6a, which are summed in f64 in a fixed order.
K1, K6a, K6b and K7 take float32 tensors of one shape at any size (the
TPU's ``HBM_REGIME_BYTES`` and tile rules have no counterpart here).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import count, counters
from .stencil import laplacian_nd

__all__ = [
    "xw_update",
    "lap3d_axpy_norm2",
    "laplacian3d",
    "cg_update",
    "p_update",
    "lsmr_update",
    "xw_update_torch",
    "lap3d_axpy_norm2_torch",
    "laplacian3d_torch",
    "cg_update_torch",
    "p_update_torch",
    "lsmr_update_torch",
    "reset_launch_counts",
    "launch_counts",
]

_MAX_GRID = 65535  # gridDim.y / gridDim.z limit of the 3-D stencil launch


# -- plain versions --------------------------------------------------------------


def xw_update_torch(x, w, vh, t1, t2, inv_a):
    """``x ← x + t1·w``, ``w ← inv_a·vh + t2·w`` in place; returns ``(x, w)``.
    Each multiply and add is rounded on its own, as the kernel does."""
    xn = x + t1 * w
    wn = inv_a * vh + t2 * w
    x.copy_(xn)
    w.copy_(wn)
    return x, w


def laplacian3d_torch(z):
    """7-point Laplacian with a zero boundary: :func:`laplacian_nd` at
    order 2, whose add order the kernel reproduces."""
    return laplacian_nd(z)


def lap3d_axpy_norm2_torch(z, v, s):
    """``vh = laplacian_nd(z) + s·v`` and ``n2 = <vh, vh>``."""
    vh = laplacian_nd(z) + s * v
    f = vh.reshape(-1)
    return vh, torch.vdot(f, f)


def cg_update_torch(x, r, p, q, alpha):
    """``x ← x + α·p``, ``r ← r − α·q`` in place and ``rho = <r', r'>``;
    returns ``(x, r, rho)``."""
    xn = x + alpha * p
    rn = r - alpha * q
    x.copy_(xn)
    r.copy_(rn)
    f = r.reshape(-1)
    return x, r, torch.vdot(f, f)


def p_update_torch(r, p, beta):
    """``p ← r + β·p`` in place; returns ``p``."""
    return p.copy_(r + beta * p)


def lsmr_update_torch(vh, h, hbar, x, c_hb, c_x, c_h, inv_a):
    """``hbar ← h + c_hb·hbar``, ``x ← x + c_x·hbar'``, ``h ← inv_a·vh +
    c_h·h`` (the old h) in place; returns ``(h, hbar, x)``."""
    hbn = h + c_hb * hbar
    xn = x + c_x * hbn
    hn = inv_a * vh + c_h * h
    hbar.copy_(hbn)
    x.copy_(xn)
    h.copy_(hn)
    return h, hbar, x


# -- argument checks -------------------------------------------------------------


def _check_f32(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    shape = tensors[0].shape
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{name}: shapes {tuple(shape)} and {tuple(t.shape)}")


def _check_3d(name, z):
    if z.ndim != 3:
        raise ValueError(f"{name}: expected a (D, H, W) grid, got shape {tuple(z.shape)}")
    D, H, _ = z.shape
    if D > _MAX_GRID or -(-H // 8) > _MAX_GRID:
        raise ValueError(f"{name}: grid {tuple(z.shape)} exceeds the launch grid")


def _scalar(x, device):
    """A 0-d float32 tensor on ``device``, on either route, so both round the
    scalar alike. LSQR's recurrence scalars already are such tensors, so
    this launches nothing for them."""
    t = torch.as_tensor(x, device=device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(()).to(torch.float32).contiguous()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_distinct(name, *tensors):
    if tensors[0].numel() and len({t.data_ptr() for t in tensors}) < len(tensors):
        raise ValueError(f"{name}: the vectors must be distinct buffers")


def _device_of(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device


# -- wrappers --------------------------------------------------------------------


def xw_update(x, w, vh, t1, t2, inv_a):
    """K1: ``x ← x + t1·w``, ``w ← inv_a·vh + t2·w``, one pass with ``x``
    and ``w`` updated in place; returns ``(x, w)``. Any shape."""
    _check_f32("xw_update", x, w, vh)
    if len({x.data_ptr(), w.data_ptr(), vh.data_ptr()}) < 3 and x.numel():
        raise ValueError("xw_update: x, w and vh must be distinct buffers")
    dev = x.device
    s1, s2, s3 = (_scalar(a, dev) for a in (t1, t2, inv_a))
    if dev.type == "cpu":
        return xw_update_torch(x, w, vh, s1, s2, s3)
    if dev.type != "cuda":
        raise ValueError(f"xw_update: no kernel for device {dev}")
    lib = kernels.load_library()
    kernels.check(lib.jt_xw_update(
        *(t.data_ptr() for t in (x, w, vh, s1, s2, s3)), x.numel(), _stream(dev)),
        "xw_update")
    count("launches.xw_update")
    return x, w


def laplacian3d(z):
    """K3: 7-point Laplacian of a (D, H, W) float32 grid, zero boundary,
    bitwise equal to :func:`laplacian_nd`."""
    _check_f32("laplacian3d", z)
    _check_3d("laplacian3d", z)
    if z.device.type == "cpu":
        return laplacian3d_torch(z)
    if z.device.type != "cuda":
        raise ValueError(f"laplacian3d: no kernel for device {z.device}")
    out = torch.empty_like(z)
    lib = kernels.load_library()
    kernels.check(lib.jt_laplacian3d(
        z.data_ptr(), out.data_ptr(), *z.shape, _stream(z.device)), "laplacian3d")
    count("launches.laplacian3d")
    return out


def lap3d_axpy_norm2(z, v, s):
    """K2: ``vh = laplacian_nd(z) + s·v`` and ``n2 = Σ vh²`` in one pass over
    the grid (plus a one-block pass over per-block partial sums). Returns
    ``(vh, n2)`` with ``n2`` a 0-d float32 tensor summed in f64."""
    _check_f32("lap3d_axpy_norm2", z, v)
    _check_3d("lap3d_axpy_norm2", z)
    dev = z.device
    s = _scalar(s, dev)
    if dev.type == "cpu":
        return lap3d_axpy_norm2_torch(z, v, s)
    if dev.type != "cuda":
        raise ValueError(f"lap3d_axpy_norm2: no kernel for device {dev}")
    lib = kernels.load_library()
    vh = torch.empty_like(z)
    n2 = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(lib.jt_lap3d_num_partials(*z.shape),
                           dtype=torch.float64, device=dev)
    kernels.check(lib.jt_lap3d_axpy_norm2(
        *(t.data_ptr() for t in (z, v, s, vh, partials, n2)), *z.shape, _stream(dev)),
        "lap3d_axpy_norm2")
    count("launches.lap3d_axpy_norm2")
    return vh, n2


def cg_update(x, r, p, q, alpha):
    """K6a: ``x ← x + α·p``, ``r ← r − α·q`` in one pass with x and r updated
    in place, and ``rho = Σ r'²`` summed in the same pass (f64 partials,
    then one fixed-order pass). Returns ``(x, r, rho)`` with ``rho`` a 0-d
    float32 tensor. Any shape."""
    name = "cg_update"
    _check_f32(name, x, r, p, q)
    dev = _device_of(name, x)
    _check_distinct(name, x, r, p, q)
    alpha = _scalar(alpha, dev)
    if dev.type == "cpu":
        return cg_update_torch(x, r, p, q, alpha)
    lib = kernels.load_library()
    rho = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(lib.jt_cg_num_partials(x.numel()), dtype=torch.float64,
                           device=dev)
    kernels.check(lib.jt_cg_update(
        *(t.data_ptr() for t in (x, r, p, q, alpha, partials, rho)), x.numel(),
        _stream(dev)), name)
    count("launches.cg_update")
    return x, r, rho


def p_update(r, p, beta):
    """K6b: ``p ← r + β·p`` in one pass, in place; returns ``p``. Any shape."""
    name = "p_update"
    _check_f32(name, r, p)
    dev = _device_of(name, r)
    _check_distinct(name, r, p)
    beta = _scalar(beta, dev)
    if dev.type == "cpu":
        return p_update_torch(r, p, beta)
    lib = kernels.load_library()
    kernels.check(lib.jt_p_update(r.data_ptr(), p.data_ptr(), beta.data_ptr(), r.numel(),
                                  _stream(dev)), name)
    count("launches.p_update")
    return p


def lsmr_update(vh, h, hbar, x, c_hb, c_x, c_h, inv_a):
    """K7: LSMR's model-space tail ``hbar ← h + c_hb·hbar``,
    ``x ← x + c_x·hbar'``, ``h ← inv_a·vh + c_h·h`` in one pass with h, hbar
    and x updated in place; returns ``(h, hbar, x)``. Any shape."""
    name = "lsmr_update"
    _check_f32(name, vh, h, hbar, x)
    dev = _device_of(name, x)
    _check_distinct(name, vh, h, hbar, x)
    s = tuple(_scalar(a, dev) for a in (c_hb, c_x, c_h, inv_a))
    if dev.type == "cpu":
        return lsmr_update_torch(vh, h, hbar, x, *s)
    lib = kernels.load_library()
    kernels.check(lib.jt_lsmr_update(
        *(t.data_ptr() for t in (vh, h, hbar, x) + s), x.numel(), _stream(dev)), name)
    count("launches.lsmr_update")
    return h, hbar, x


_WRAPPERS = (xw_update, lap3d_axpy_norm2, laplacian3d, cg_update, p_update, lsmr_update)


def _launch_counters(wrappers):
    """``(reset_launch_counts, launch_counts)`` of a module's ``wrappers``:
    views of the registry's counters ``launches.<wrapper>``."""
    keys = [f"launches.{fn.__name__}" for fn in wrappers]

    def reset_launch_counts() -> None:
        counters(keys, reset=True)

    def launch_counts() -> dict:
        return {fn.__name__: n for fn, n in zip(wrappers, counters(keys).values())}

    return reset_launch_counts, launch_counts


reset_launch_counts, launch_counts = _launch_counters(_WRAPPERS)
