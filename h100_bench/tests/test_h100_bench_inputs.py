"""The Marmousi configuration's inputs: the seeded field's ranges and the
survey's windows, at the full size on the CPU."""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import generator, inputs  # noqa: E402

HERE = Path(__file__).resolve().parents[1]
CFG = json.loads((HERE / "configs" / "marmousi2d-iso.json").read_text())


def test_marmousi_field_ranges():
    c_true, c0 = inputs.models(CFG, 2**31 + 11, "cpu")
    assert tuple(c_true.shape) == tuple(c0.shape) == (751, 2301)
    vmin, vmax = CFG["velocity_m_s"]
    water = int(CFG["water_depth_m"] / CFG["spacing_m"])
    for c in (c_true, c0):
        assert c.dtype == torch.float32
        assert float(c.min()) == vmin and float(c.max()) <= vmax
        assert torch.all(c[:water] == vmin)
    assert torch.all(c_true[water:] >= 1600.0)
    assert float(c_true.max()) == vmax  # the Courant number is set at 5.5 km/s
    assert float(torch.mean(torch.abs(c0 - c_true))) > 10.0  # c0 is smoothed


def test_marmousi_seeds_change_the_field_not_its_size():
    a, _ = inputs.models(CFG, 1, "cpu")
    b, _ = inputs.models(CFG, 2**33 + 1, "cpu")
    again, _ = inputs.models(CFG, 1, "cpu")
    assert a.shape == b.shape and not torch.equal(a, b) and torch.equal(a, again)


def test_survey_windows_cover_every_receiver():
    D, W = CFG["window_shape"]
    margin = round(CFG["window_margin_m"] / CFG["spacing_m"])
    rcv = inputs.receiver_flat(CFG)
    assert len(rcv) == CFG["survey"]["nreceivers"] == 96
    rz, rx = np.divmod(rcv, W)
    assert np.all(rz == 3) and rx.min() >= margin  # 12 m; 0.5 km inside the window
    n = inputs.source_positions(CFG)
    assert n == 226  # shots 3 to 228 of the 240
    for p in range(n):
        corner, src = inputs.shot_geometry(CFG, p)
        sz, sx = divmod(src, W)
        assert sz == 2 and W - 1 - sx == margin  # 8 m; 0.5 km from the far edge
        assert corner[0] == 0 and 0 <= corner[1] and corner[1] + W <= CFG["grid_shape"][1]
        # the source at the survey's position, the streamer 200 m to 2575 m behind it
        x_src = (corner[1] + sx) * CFG["spacing_m"]
        assert abs(x_src - (3000.0 + 25.0 * (p + 3))) <= 2.0
        offsets = (sx - rx) * CFG["spacing_m"]
        assert np.all(np.abs(offsets - (200.0 + 25.0 * np.arange(96))) <= 2.0)


def test_traffic_draws_distinct_shots():
    sched = generator.schedule({"pool": 2, "shots_per_unit": 4}, 2**40 + 7,
                               inputs.source_positions(CFG))
    shots = [s for row in sched.pool for s in row]
    assert len(set(shots)) == 8 and all(0 <= s < 226 for s in shots)
