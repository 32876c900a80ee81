"""Example 10 — RTM imaging condition from COMPRESSED forward snapshots
(the port of ``examples/10_compressed_snapshot_rtm.py``).

The adjoint-state imaging condition needs the forward wavefield at every
time step while sweeping the receiver residual BACKWARDS in time. Holding
nt full grids is the memory wall; the reference family's propagators
serialize the forward field through a lossy C++ compressor (CvxCompress)
instead. jets_tpu_torch ships both halves of that trade:

* ``remat_blocks`` — recompute (O(√nt) memory), and
* ``jets_tpu_torch.utils.SnapshotStore`` — serialize (fixed-rate
  block-float codec, native C++ with a byte-identical numpy fallback) —
  this example.

We build a source wavefield, append each step to a 12-bit store (~2.7×
smaller), run the reverse sweep of the residual field, and form the
zero-lag cross-correlation image from the DECOMPRESSED snapshots. The
compressed-image/raw-image correlation shows why ~60 dB block-SNR is
imaging-grade. The 2-D step here is plain PyTorch.

Run: ``python examples_torch/10_compressed_snapshot_rtm.py [--device cpu]``
(the CUDA card by default).
"""
import argparse

import numpy as np
import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.stencil import laplacian_nd
from jets_tpu_torch.ops.wave import _ricker, _sponge
from jets_tpu_torch.utils import SnapshotStore, compression_ratio


def main(device=None) -> dict:
    """Forward, compressed store, reverse sweep and both images on
    ``device`` (``None``: the card); no random input."""
    dev = resolve_device(device)
    n, nt, dt, dx = 48, 240, 0.0012, 10.0
    grid = (n, n)
    c0 = torch.full(grid, 2000.0, device=dev)
    # reflectivity: a dipping interface
    refl = torch.zeros(grid, device=dev)
    for i in range(10, 38):
        refl[24 + (i - 24) // 6, i] = 1.0

    sponge = _sponge(grid, 8).to(dev)
    wav = _ricker(nt, dt, 12.0, torch.float32)
    src = (4, n // 2)
    c2dt2 = (c0 * c0) * (dt * dt) / (dx * dx)

    def step(u_prev, u, s_amp, mask):
        return (2.0 * u - u_prev + c2dt2 * laplacian_nd(u)) * sponge + s_amp * mask

    src_mask = torch.zeros(grid, device=dev)
    src_mask[src] = 1.0

    # -- forward sweep: append every snapshot to the compressed store -----
    store = SnapshotStore(grid, bits=12)          # in-memory; path=... for disk
    raw = []                                      # reference (uncompressed)
    u_prev = u = torch.zeros(grid, device=dev)
    for t in range(nt):
        u_prev, u = u, step(u_prev, u, float(wav[t]), src_mask)
        store.append(u)
        raw.append(u.cpu().numpy())
    print(f"stored {len(store)} snapshots, ratio {store.ratio:.2f}x "
          f"(format bound {compression_ratio(n * n, 12):.2f}x)")

    def snap(t):
        return torch.as_tensor(store.read(t)).to(dev)

    # -- synthetic 'residual' at a surface cable: demigrated reflectivity --
    # (toy: the secondary source is refl * u_t; record at the surface row)
    rec_row = 3
    d = []
    v_prev = v = torch.zeros(grid, device=dev)
    for t in range(nt):
        v_prev, v = v, step(v_prev, v, 1.0, refl * snap(t))
        d.append(v[rec_row].clone())

    # -- reverse sweep + imaging condition from DECOMPRESSED snapshots -----
    def migrate(snap_at):
        img = np.zeros(grid, np.float32)
        b_prev = b = torch.zeros(grid, device=dev)
        for t in range(nt - 1, -1, -1):
            inj = torch.zeros(grid, device=dev)
            inj[rec_row] = d[t]
            b_prev, b = b, step(b_prev, b, 1.0, inj)
            img += b.cpu().numpy() * snap_at(t)
        return img

    img_comp = migrate(store.read)
    img_raw = migrate(lambda t: raw[t])

    cc = float(np.sum(img_comp * img_raw)
               / (np.linalg.norm(img_comp) * np.linalg.norm(img_raw)))
    print(f"compressed-vs-raw image correlation: {cc:.6f}")
    assert cc > 0.999, cc
    # the image peaks on the reflector row band
    band = np.abs(img_comp[20:30]).sum()
    total = np.abs(img_comp).sum()
    print(f"energy in reflector band: {band / total:.1%}")
    assert band / total > 0.35
    print("OK")
    return {"ratio": store.ratio, "bound": compression_ratio(n * n, 12), "cc": cc,
            "band": float(band / total)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="RTM from compressed forward snapshots")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
