"""mfu.train: the model FLOPs of the window's training steps (6 x the
weights a token multiplies by, the head included, plus causal
attention; no recompute) over its seconds times 989 TFLOP/s, in %."""

from portbench.harness.readings import train_mfu as read  # noqa: F401
