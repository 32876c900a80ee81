"""The card's state beside the window: ``nvidia-smi`` in a process of its
own, sampling the card once a second while the window runs.

The samples go to a CSV file under ``h100_bench/out/clocks/``; the
summary line gives each field's minimum, median and maximum over them
(the throttle reasons, a bit mask, in hexadecimal). Where ``nvidia-smi``
is missing, as on a machine without a card, nothing is sampled and the
summary says so.
"""
from __future__ import annotations

import shutil
import statistics
import subprocess
from pathlib import Path

__all__ = ["FIELDS", "Sampler", "summarize"]

FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "power.limit", "temperature.gpu",
          "clocks_throttle_reasons.active")
_UNITS = {"clocks.sm": "MHz", "clocks.mem": "MHz", "power.draw": "W", "power.limit": "W",
          "temperature.gpu": "C"}
_QUERY = ["--query-gpu=" + ",".join(FIELDS), "--format=csv,noheader,nounits"]


class Sampler:
    """``start()`` before the window, ``stop()`` after it; ``summary()``
    reads the samples."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.smi = shutil.which("nvidia-smi")
        self.proc = None

    def start(self, uuid=None):
        """Sample the card of ``uuid`` (as ``torch.cuda`` gives it; ``None``:
        every card) once a second until ``stop()``."""
        if not self.smi:
            return
        card = []
        if uuid is not None:
            card_id = str(uuid)
            card = ["--id=" + (card_id if card_id.startswith("GPU-") else "GPU-" + card_id)]
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as out:
            self.proc = subprocess.Popen([self.smi, *_QUERY, "-lms", "1000", *card],
                                         stdout=out, stderr=subprocess.STDOUT)

    def stop(self):
        """End the sampling process and wait until it has ended."""
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def summary(self) -> str:
        if not self.smi:
            return "card during the window: not sampled (no nvidia-smi)"
        text = self.path.read_text() if self.path.is_file() else ""
        return summarize(text)


def summarize(text: str) -> str:
    """``card during the window: <field> min/median/max <unit>; ...`` of
    the CSV lines ``text`` (one sample a line, ``FIELDS`` in order)."""
    rows = [[v.strip() for v in line.split(",")] for line in text.splitlines()]
    rows = [r for r in rows if len(r) == len(FIELDS)]
    parts = []
    for i, f in enumerate(FIELDS):
        vals = []
        for r in rows:
            try:
                vals.append(int(r[i], 16) if r[i].startswith("0x") else float(r[i]))
            except ValueError:
                pass
        if not vals:
            parts.append(f"{f} -")
        elif f.endswith("reasons.active"):
            parts.append(f"{f} {min(vals):#x}/{sorted(vals)[len(vals) // 2]:#x}/{max(vals):#x}")
        else:
            parts.append(f"{f} {min(vals):g}/{statistics.median(vals):g}/{max(vals):g}"
                         f" {_UNITS.get(f, '')}".rstrip())
    return f"card during the window ({len(rows)} samples, min/median/max): " + "; ".join(parts)
