"""Example 4 — out-of-core inversion with the native data loader (the port
of ``examples/04_out_of_core.py``).

When the observed data for all shots exceeds device memory, stream shot
blocks from the on-disk store (C++ background prefetch) and accumulate the
model gradient blockwise — steepest descent on the normal equations with
the per-block rows of the stacked operator.

Run: ``python examples_torch/04_out_of_core.py [--device cpu]`` (the CUDA
card by default).
"""
import argparse
import os
import tempfile

import torch

from jets_tpu_torch.core.spaces import as_tensor, resolve_device
from jets_tpu_torch.models.seismic import make_seismic_operator
from jets_tpu_torch.utils.dataloader import ShotGatherLoader, ShotGatherStore


def main(device=None, *, wr=None, m_true=None) -> dict:
    """Three streamed gradient steps on ``device`` (``None``: the card).
    ``wr`` (the per-shot weights) and ``m_true`` replace their seeded
    draws."""
    dev = resolve_device(device)
    grid, nshots, nrecv, batch = (128, 128), 32, 256, 8
    A = make_seismic_operator(grid, nshots, nrecv, torch.Generator().manual_seed(0),
                              wr=wr, device=dev)
    if m_true is None:
        m_true = torch.randn(grid, generator=torch.Generator().manual_seed(1)) * 0.1
    d_obs = A(as_tensor(m_true).to(dev, torch.float32))

    # persist the data like a field dataset, then stream it back per block
    with tempfile.TemporaryDirectory() as tmp:
        store = ShotGatherStore.create(os.path.join(tmp, "shots.bin"), d_obs.cpu().numpy())
        loader = ShotGatherLoader(store, batch_shots=batch, queue_depth=2)
        print(f"store: {nshots} shots, native prefetch: {loader.native}")

        # one streamed gradient: g = sum_blocks J_b' (J_b m - d_b), where J_b
        # is the rows of A for that shot block (a restriction of the range)
        def block_grad(m, d_block, lo):
            r = torch.zeros(A.rng.shape, dtype=d_block.dtype, device=dev)
            r[lo:lo + d_block.shape[0]] = A(m)[lo:lo + d_block.shape[0]] - d_block
            return A.H(r)

        m = torch.zeros(grid, device=dev)
        rels = []
        for step in range(3):
            g = torch.zeros(grid, device=dev)
            for idx, block in loader:
                g = g + block_grad(m, torch.as_tensor(block).to(dev), idx * batch)
            m = m - 0.4 * g / (1e-9 + float(torch.linalg.norm(g)))
            rel = float(torch.linalg.norm(A(m) - d_obs) / torch.linalg.norm(d_obs))
            print(f"step {step}: streamed gradient, rel residual {rel:.3f}")
            rels.append(rel)
        native = loader.native
    return {"native": native, "relres": rels}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="streamed out-of-core gradient steps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
