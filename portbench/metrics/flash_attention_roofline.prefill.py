"""flash_attention_roofline.prefill: the least time of the forward work
of the calls into ``repro_torch.kernels.flash_attention`` (from their shapes,
``portbench/work/counts.py``) over their device time, in %.  The calls
are found by the call into the module, not by kernel name."""

from portbench.harness.readings import roofline

SPANS = ("flash_attention",)


def read(rec):
    return roofline(rec, "flash_attention")
