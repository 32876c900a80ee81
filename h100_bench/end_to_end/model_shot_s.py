"""``model_shot_s`` of ``overthrust-iso-model``: wall seconds of the window per shot its
forward-modelling units completed."""
from h100_bench.readers import seconds_per_shot as read  # noqa: F401
