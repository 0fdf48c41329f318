"""Where this process stands among the processes of one run, and the
collectives the host side needs: the names of
:mod:`snn_automotive_object_detection_tpu_torch.parallel.collectives`,
which holds them, under the module path the host side has imported them
from."""

from snn_automotive_object_detection_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_objects,
    all_reduce_sum,
    parallel_world,
)
