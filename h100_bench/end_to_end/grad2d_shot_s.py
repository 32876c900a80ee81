"""``grad2d_shot_s`` of ``marmousi-iso-grad``: wall seconds of the window per shot its
2-D objective-and-gradient units completed."""
from h100_bench.readers import seconds_per_shot as read  # noqa: F401
