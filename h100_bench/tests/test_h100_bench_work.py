"""The work counts against hand counts."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import peaks  # noqa: E402
from h100_bench.work import lsqr, wave  # noqa: E402


def test_laplacian_flops():
    # centre multiply; per axis and tap pair: a multiply unless the
    # coefficient is 1, the pair's add and the accumulation
    assert wave.laplacian_flops(2) == 1 + 0 + 6
    assert wave.laplacian_flops(4) == 1 + 6 + 12
    assert wave.laplacian_flops(8) == 1 + 12 + 24
    assert wave.laplacian_flops(8, ndim=2) == 1 + 8 + 16


def test_step_bytes():
    assert wave.step_bytes("forward") == 16  # u_prev, u, c read; u' written
    assert wave.step_bytes("forward_hist") == 17  # + the int8 snapshot
    assert wave.step_bytes("reverse") == 25  # a1, a2, g, c, q read; a, g written


def test_step_flops():
    assert wave.step_flops("forward", 2) == 14
    assert wave.step_flops("reverse", 2) == 25
    assert wave.step_flops("forward_hist", 8) == 37 + 7 + 3
    assert wave.step_flops("reverse", 8) == 2 * 37 + 11
    # 2-D: one sponge factor product fewer a cell
    assert wave.step_flops("forward", 8, ndim=2) == 25 + 6
    assert wave.step_flops("forward_hist", 8, ndim=2) == 25 + 6 + 3
    assert wave.step_flops("reverse", 8, ndim=2) == 2 * 25 + 10


def test_unit_work():
    cells = 187 * 401 * 401
    g = wave.unit_work("gradient", shots=4, nt=2000, window_shape=(187, 401, 401),
                       nreceivers=201 * 201, order=8)
    assert g["bytes"] == 4 * 2000 * (42 * cells + 12 * 201 * 201)
    f = wave.unit_work("forward", shots=4, nt=2000, window_shape=(187, 401, 401),
                       nreceivers=201 * 201, order=8)
    assert f["bytes"] == 4 * 2000 * (16 * cells + 4 * 201 * 201)
    assert f["flops"] == 4 * 2000 * 44 * cells
    # both are bound by bytes on the H100
    assert peaks.least_seconds(g) == g["bytes"] / peaks.HBM_BYTES_PER_S


def test_unit_work_2d():
    cells = 751 * 895
    g = wave.unit_work("gradient", shots=4, nt=11140, window_shape=(751, 895),
                       nreceivers=96, order=8)
    # 42 B a cell-step in 2-D as in 3-D, 12 B a receiver and step
    assert g["bytes"] == 4 * 11140 * (42 * cells + 12 * 96)
    assert g["flops"] == 4 * 11140 * (34 + 60) * cells
    assert peaks.least_seconds(g) == g["bytes"] / peaks.HBM_BYTES_PER_S
    # 8.4 us a shot-step at 3.35 TB/s
    assert abs(peaks.least_seconds(g) / (4 * 11140) - 8.43e-6) < 0.01e-6


def test_lsqr_work():
    cells, data = 256**3, 256 * 4096
    it = lsqr.iteration_work((256, 256, 256), 256, 4096)
    assert it["bytes"] == 24 * cells + 12 * data
    s = lsqr.solve_work((256, 256, 256), 256, 4096, 50)
    assert s["bytes"] == 50 * it["bytes"] + 12 * cells + 12 * data
    assert abs(peaks.least_seconds(it) - 0.1240e-3) < 0.0005e-3
