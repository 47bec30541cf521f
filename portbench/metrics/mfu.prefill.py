"""mfu.prefill: the model FLOPs of every prompt the window served (2 x
the weights a position multiplies by, the head at the last position
only, plus causal attention) over its seconds times 989 TFLOP/s, in %."""

from portbench.harness.readings import prefill_mfu as read  # noqa: F401
