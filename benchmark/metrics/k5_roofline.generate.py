"""k5_roofline.generate: kernel K5's least time for the batch's solves
(``benchmark/work/k5.py``, the configuration's full iteration budget, over
``benchmark/work/peaks.py``) over its mean traced device time a launch, in
percent, as ``k5_roofline.datagen`` reckons it.  None where the trace
holds no K5 launch."""

from benchmark.metrics_lib import k5_roofline as read  # noqa: F401
