"""The summary of the card's samples, on text as ``nvidia-smi`` writes it."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import clocks  # noqa: E402

SAMPLES = """1980, 2619, 692.61, 700.00, 57, 0x0000000000000004
1965, 2619, 695.86, 700.00, 59, 0x0000000000000004
1755, 2619, 699.10, 700.00, 60, 0x0000000000000000
"""


def test_summary_min_median_max():
    line = clocks.summarize(SAMPLES)
    assert line.startswith("card during the window (3 samples, min/median/max): ")
    assert "clocks.sm 1755/1965/1980 MHz" in line
    assert "power.draw 692.61/695.86/699.1 W" in line
    assert "temperature.gpu 57/59/60 C" in line
    assert "clocks_throttle_reasons.active 0x0/0x4/0x4" in line


def test_summary_without_samples(tmp_path):
    assert "clocks.sm -" in clocks.summarize("nvidia-smi: command failed\n")
    sampler = clocks.Sampler(tmp_path / "c.csv")
    sampler.smi = None  # as on a machine without the tool
    sampler.start()
    sampler.stop()
    assert "not sampled" in sampler.summary()
