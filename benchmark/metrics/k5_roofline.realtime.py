"""k5_roofline.realtime: kernel K5's least time for the single
stream's solve (``benchmark/work/k5.py`` over ``benchmark/work/peaks.py``)
over its mean traced device time a launch, in percent.  None where the trace holds no
K5 launch."""

from benchmark.metrics_lib import k5_roofline as read  # noqa: F401
