"""The benchmark's inputs, made from ``--seed`` on the device: velocity
models, shot geometry, receiver weights and model vectors. Both the
program and the plain reference are handed what is made here; nothing
here imports the program.

A wave configuration names its ``velocity_model`` (``overthrust``,
``marmousi``) and its ``geometry`` (``surface_grid``: sources on a grid of
the surface, each in a window centred on it, receivers on a regular grid
of the window's surface; ``streamer``: a marine line survey, each shot's
window placed at the same offsets from its source, so every shot has the
same window-relative receivers).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generator", "models", "shot_geometry", "source_positions", "receiver_flat",
           "overthrust_models", "marmousi_models", "flagship_receivers", "flagship_weights",
           "flagship_model"]


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and a salt
    (any whole numbers; folded to 63 bits)."""
    mixed = np.random.SeedSequence([int(seed) & (2**64 - 1), int(salt)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & (2**63 - 1))


def models(cfg: dict, seed: int, device):
    """``(c_true, c0)`` of the configuration's ``velocity_model``."""
    return {"overthrust": overthrust_models, "marmousi": marmousi_models}[
        cfg["velocity_model"]](cfg, seed, device)


def overthrust_models(cfg: dict, seed: int, device):
    """``(c_true, c0)``: a layered, folded and thrust-faulted velocity field
    within ``cfg["velocity_m_s"]`` on ``cfg["grid_shape"]`` (axis 0 depth),
    and the starting model, the field smoothed by passes of a box filter."""
    D, H, W = cfg["grid_shape"]
    dx = float(cfg["spacing_m"])
    vmin, vmax = (float(v) for v in cfg["velocity_m_s"])
    g = generator(seed, device, 1)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=torch.float64)

    y = torch.arange(H, device=device, dtype=torch.float32).reshape(1, H, 1) * dx
    x = torch.arange(W, device=device, dtype=torch.float32).reshape(1, 1, W) * dx
    z = torch.arange(D, device=device, dtype=torch.float32).reshape(D, 1, 1) * dx
    # folds: four plane waves of the horizons, 100-400 m high, 3-12 km long
    a, lam, th, ph = (100 + 300 * rand(4), 3000 + 9000 * rand(4), math.pi * rand(4),
                      2 * math.pi * rand(4))
    shift = torch.zeros((1, H, W), device=device)
    for k in range(4):
        arg = (y * math.cos(th[k]) + x * math.sin(th[k])) * (2 * math.pi / lam[k]) + ph[k]
        shift = shift + float(a[k]) * torch.sin(arg)
    # a thrust: a plane dipping 30-45 degrees across the model, its hanging
    # wall lifted by 300-700 m
    f = rand(4)
    ang, dip = math.pi * float(f[0]), math.radians(30 + 15 * float(f[1]))
    s0 = (0.3 + 0.4 * float(f[2])) * dx * min(H, W)
    throw = 300 + 400 * float(f[3])
    across = y * math.cos(ang) + x * math.sin(ang) - s0
    hanging = (across - z / math.tan(dip)) > 0
    depth = z + shift + throw * hanging.to(torch.float32)
    del hanging, across
    # layers 60-250 m thick, velocity rising with depth, +-250 m/s per layer
    nlay = 96
    bounds = torch.cumsum(60 + 190 * rand(nlay), 0) - 800.0
    trend = vmin + (vmax - vmin) * torch.clamp(
        (bounds + 800.0) / (D * dx + 1600.0), 0.0, 1.0) ** 0.8
    vel = torch.clamp(trend + 250 * (2 * rand(nlay) - 1), vmin, vmax)
    vel = torch.cat([vel, vel[-1:]]).to(torch.float32)
    layer = torch.bucketize(depth, bounds.to(torch.float32), out_int32=True)
    del depth
    c_true = vel[layer]
    del layer
    return c_true.contiguous(), _smooth(c_true, cfg)


def _smooth(c, cfg):
    """``c`` smoothed by ``starting_model_smoothing``'s passes of a box
    filter (``avg_pool2d``/``avg_pool3d``, edges averaged over the cells
    inside)."""
    sm = cfg["starting_model_smoothing"]
    k = int(sm["box_cells"])
    pool = torch.nn.functional.avg_pool3d if c.ndim == 3 else torch.nn.functional.avg_pool2d
    out = c[None, None]
    for _ in range(int(sm["passes"])):
        out = pool(out, k, stride=1, padding=k // 2, count_include_pad=False)
    return out[0, 0].contiguous()


def marmousi_models(cfg: dict, seed: int, device):
    """``(c_true, c0)`` on ``cfg["grid_shape"]`` (axis 0 depth): a water
    layer of ``water_depth_m`` at the lower end of ``cfg["velocity_m_s"]``
    over dipping, gently folded strata cut by normal faults, velocity rising
    with depth, and a high-velocity layer at the upper end; the starting
    model is the field smoothed, the water kept."""
    Z, X = cfg["grid_shape"]
    dx = float(cfg["spacing_m"])
    vwater, vmax = (float(v) for v in cfg["velocity_m_s"])
    wd = float(cfg["water_depth_m"])
    g = generator(seed, device, 1)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=torch.float64)

    z = torch.arange(Z, device=device, dtype=torch.float32).reshape(Z, 1) * dx
    x = torch.arange(X, device=device, dtype=torch.float32).reshape(1, X) * dx
    # strata dipping 2-8 degrees about the model's middle, two folds 30-120 m
    # high and 2-6 km long
    d = rand(7)
    depth = z - wd - (x - 0.5 * X * dx) * math.tan(math.radians(2 + 6 * float(d[0])))
    for k in range(2):
        amp, lam, ph = 30 + 90 * float(d[1 + 3 * k]), 2000 + 4000 * float(d[2 + 3 * k]), \
            2 * math.pi * float(d[3 + 3 * k])
        depth = depth + amp * torch.sin(x * (2 * math.pi / lam) + ph)
    # four normal faults dipping 50-70 degrees, hanging walls dropped 100-400 m
    f = rand(4, 3)
    for k in range(4):
        x0 = (0.15 + 0.7 * float(f[k, 0])) * X * dx
        ang = math.radians(50 + 20 * float(f[k, 1]))
        hanging = (x - x0 + (z - wd) / math.tan(ang)) < 0
        depth = depth - (100 + 300 * float(f[k, 2])) * hanging.to(torch.float32)
    # layers 30-180 m thick, 1.6 km/s under the sea floor rising to 5 km/s
    # at the bottom, +-300 m/s per layer, and one high-velocity (carbonate)
    # layer at the upper end, 50-150 m thick, 2.0-2.4 km under the sea floor
    nlay = 160
    bounds = torch.cumsum(30 + 150 * rand(nlay), 0) - 1500.0
    frac = torch.clamp(bounds / (Z * dx - wd), 0.0, 1.0)
    vel = torch.clamp(1600 + 3400 * frac ** 0.9 + 300 * (2 * rand(nlay) - 1), 1600, vmax)
    vel = torch.cat([vel, vel[-1:]]).to(torch.float32)
    c_true = vel[torch.bucketize(depth, bounds.to(torch.float32), out_int32=True)]
    top = 2000 + 400 * float(d[6])
    carbonate = (depth >= top) & (depth < top + 50 + 100 * float(f[0, 0]))
    c_true = torch.where(carbonate, torch.full_like(c_true, vmax), c_true)
    water = z < wd
    c_true = torch.where(water, torch.full_like(c_true, vwater), c_true).contiguous()
    c0 = torch.where(water, torch.full_like(c_true, vwater), _smooth(c_true, cfg))
    return c_true, c0.contiguous()


def receiver_flat(cfg: dict) -> np.ndarray:
    """Window-relative flat indices of the receivers, the same for every
    shot."""
    if cfg["geometry"] == "streamer":
        _, W = cfg["window_shape"]
        zr = _cells(cfg["receiver_depth_m"], cfg)
        return (zr * W + _source_column(cfg) - _streamer_offsets(cfg)).astype(np.int64)
    _, H, W = cfg["window_shape"]
    st, zr = int(cfg["receiver_step"]), int(cfg["receiver_depth_index"])
    ys, xs = np.arange(0, H, st), np.arange(0, W, st)
    return (zr * H * W + ys[:, None] * W + xs[None, :]).reshape(-1).astype(np.int64)


def _cells(metres, cfg) -> int:
    """The grid cell nearest ``metres`` from the origin."""
    return int(math.floor(float(metres) / float(cfg["spacing_m"]) + 0.5))


def _streamer_offsets(cfg: dict) -> np.ndarray:
    """Each receiver's distance from its source in cells (the streamer
    trails the source toward x = 0)."""
    s = cfg["survey"]
    return np.array([_cells(float(s["near_offset_m"]) + k * float(s["receiver_spacing_m"]),
                            cfg) for k in range(int(s["nreceivers"]))], np.int64)


def _source_column(cfg: dict) -> int:
    """The source's column in its window: the window's margin from the
    window's far (x-increasing) edge."""
    return int(cfg["window_shape"][1]) - 1 - _cells(cfg["window_margin_m"], cfg)


def _streamer_shots(cfg: dict) -> list:
    """The survey's shots whose window lies inside the model: ``(shot,
    source column)``."""
    s = cfg["survey"]
    nx, col = int(cfg["grid_shape"][1]), _source_column(cfg)
    out = []
    for i in range(int(s["nshots"])):
        sx = _cells(float(s["first_shot_m"]) + i * float(s["shot_spacing_m"]), cfg)
        if sx - col >= 0 and sx - col + int(cfg["window_shape"][1]) <= nx:
            out.append((i, sx))
    return out


def shot_geometry(cfg: dict, position: int):
    """``(corner, src_flat)`` of the shot at ``position`` among the
    candidates: the window's corner in the model and the source's
    window-relative flat index. ``surface_grid``: position row-major over
    the source grid's y, x, the window centred on the source and clipped to
    the model. ``streamer``: the ``position``-th shot whose window lies
    inside the model."""
    if cfg["geometry"] == "streamer":
        _, sx = _streamer_shots(cfg)[int(position)]
        col = _source_column(cfg)
        return (0, sx - col), _cells(cfg["source_depth_m"], cfg) * int(
            cfg["window_shape"][1]) + col
    sg = cfg["source_grid"]
    n = int(sg["count"])
    iy, ix = divmod(int(position), n)
    sy, sx = (int(sg["start"]) + int(sg["step"]) * i for i in (iy, ix))
    _, H, W = cfg["grid_shape"]
    _, wh, ww = cfg["window_shape"]
    cy = min(max(sy - wh // 2, 0), H - wh)
    cx = min(max(sx - ww // 2, 0), W - ww)
    zs = int(cfg["source_depth_index"])
    return (0, cy, cx), (zs * wh + (sy - cy)) * ww + (sx - cx)


def source_positions(cfg: dict) -> int:
    """How many shots the traffic draws from."""
    if cfg["geometry"] == "streamer":
        return len(_streamer_shots(cfg))
    return int(cfg["source_grid"]["count"]) ** 2


def flagship_receivers(cfg: dict):
    """Per-axis receiver coordinates of the regular subgrid."""
    sub = cfg["receiver_subgrid"]
    return [np.asarray(s) + np.asarray(st) * np.arange(c)
            for s, st, c in zip(sub["start"], sub["stride"], sub["count"])]


def flagship_weights(cfg: dict, seed: int, device) -> torch.Tensor:
    """``wr`` (nshots, nreceivers): a Gaussian illumination around a source
    drawn from the seed for each shot, at the receivers, float32."""
    g = generator(seed, device, 2)
    shape = cfg["grid_shape"]
    ns = int(cfg["nshots"])
    centres = torch.stack([torch.randint(0, s, (ns,), generator=g, device=device)
                           for s in shape], 1).to(torch.float64)
    axes = [torch.as_tensor(a, dtype=torch.float64, device=device)
            for a in flagship_receivers(cfg)]
    coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(shape))
    r2 = torch.sum((coords[None] - centres[:, None]) ** 2, -1)
    sig = float(cfg["illumination_sigma_cells"])
    return torch.exp(-0.5 * r2 / sig**2).to(torch.float32)


def flagship_model(cfg: dict, seed: int, device) -> torch.Tensor:
    """A model vector: sparse unit spikes over a weak Gaussian background,
    float32."""
    g = generator(seed, device, 3)
    n = math.prod(cfg["grid_shape"])
    m = float(cfg["model"]["background"]) * torch.randn(n, generator=g, device=device)
    k = int(n * float(cfg["model"]["spike_fraction"]))
    m[torch.randperm(n, generator=g, device=device)[:k]] += 1.0
    return m.reshape(cfg["grid_shape"])
