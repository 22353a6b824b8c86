"""matcher_device_ms.serve: device time a request of the ops launched inside the
program's spans encoder_4a_prep_features and encoder_4b_cost_volume_matching
(the UV matcher and what it is given)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "encoder_4a_prep_features", "encoder_4b_cost_volume_matching")
