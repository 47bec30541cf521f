"""idle_share.train: the share of the traced window in which no operation
ran on the device, in %: 1 - busy / window, both from ``torch.profiler``'s
trace of the card (busy the union of the operations' intervals).  The
profiler slows the host's launches and lengthens short kernels, so this
reads above the idle share of an unprofiled window."""

from portbench.harness.readings import idle_share as read  # noqa: F401
