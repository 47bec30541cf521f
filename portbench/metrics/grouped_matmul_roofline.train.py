"""grouped_matmul_roofline.train: the least time of the forward and backward work
of the calls into ``repro_torch.kernels.grouped_matmul`` (from their shapes,
``portbench/work/counts.py``) over their device time, in %.  The calls
are found by the call into the module, not by kernel name."""

from portbench.harness.readings import roofline

SPANS = ("grouped_matmul",)


def read(rec):
    return roofline(rec, "grouped_matmul")
