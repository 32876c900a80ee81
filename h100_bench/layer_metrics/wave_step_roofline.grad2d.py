"""``wave_step_roofline.grad2d`` of ``marmousi-iso-grad``: the least time of its traced
2-D objective-and-gradient units over their device-busy time, in %."""
from h100_bench.readers import step_roofline as read  # noqa: F401
