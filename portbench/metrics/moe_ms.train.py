"""moe_ms.train: device ms of the calls into
``repro_torch.models.moe.moe_mlp`` and of their backward (from the
output's gradient to the input's), the layers' recomputation taken out
of the backward and counted as the calls it makes, per optimizer step."""

from portbench.harness.readings import span_ms_per_step

SPANS = ("moe", "recompute")


def read(rec):
    return span_ms_per_step(rec, "moe")
