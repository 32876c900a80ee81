"""``launches_per_step.grad2d`` of ``marmousi-iso-grad``: device operations per
shot-step of its traced 2-D objective-and-gradient units."""
from h100_bench.readers import launches_per_step as read  # noqa: F401
