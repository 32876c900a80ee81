"""``launches_per_step.grad`` of ``overthrust-iso-grad``: device operations per
shot-step of its traced 3-D objective-and-gradient units."""
from h100_bench.readers import launches_per_step as read  # noqa: F401
