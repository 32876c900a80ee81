"""``grad_shot_s`` of ``overthrust-iso-grad``: wall seconds of the window per shot its
3-D objective-and-gradient units completed."""
from h100_bench.readers import seconds_per_shot as read  # noqa: F401
