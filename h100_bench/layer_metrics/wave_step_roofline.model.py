"""``wave_step_roofline.model`` of ``overthrust-iso-model``: the least time of its traced
forward-modelling units over their device-busy time, in %."""
from h100_bench.readers import step_roofline as read  # noqa: F401
