"""Hand-written CUDA kernels of the LSQR solver tail (counterpart of
``jets_tpu/ops/pallas_solver.py``), with their plain PyTorch versions.

=====================  ==========================================  ========
wrapper                replaces (TPU kernel)                       plain
=====================  ==========================================  ========
:func:`xw_update`      ``pallas_solver.xw_update`` (K1)            :func:`xw_update_torch`
:func:`lap3d_axpy_norm2` ``pallas_solver.lap3d_axpy_norm2`` (K2)   :func:`lap3d_axpy_norm2_torch`
:func:`laplacian3d`    ``pallas_solver.laplacian3d`` (K3)          :func:`laplacian3d_torch`
=====================  ==========================================  ========

The kernels live in ``csrc/solver_kernels.cu`` (design notes there) and
are built by :mod:`jets_tpu_torch.kernels`. Each wrapper checks device,
dtype (float32), shape and contiguity and raises on anything its kernel
does not take. For a tensor on the CPU it calls the plain version; for a
CUDA tensor it launches the kernel or raises — there is no fallback. Each
wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain int)
so a run can show that its main path went through the kernel.

On the card the kernels are bitwise equal to their plain versions (no FMA
contraction; the stencil keeps ``laplacian_nd``'s add order), except the
norm of K2, which is summed in f64 in a fixed order.
"""
from __future__ import annotations

import torch

from .. import kernels
from .stencil import laplacian_nd

__all__ = [
    "xw_update",
    "lap3d_axpy_norm2",
    "laplacian3d",
    "xw_update_torch",
    "lap3d_axpy_norm2_torch",
    "laplacian3d_torch",
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
    xw_update.launches += 1
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
    laplacian3d.launches += 1
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
    lap3d_axpy_norm2.launches += 1
    return vh, n2


_WRAPPERS = (xw_update, lap3d_axpy_norm2, laplacian3d)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
