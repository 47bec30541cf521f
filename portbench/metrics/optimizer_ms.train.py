"""optimizer_ms.train: device ms of the calls into
``repro_torch.optim.adamw.update`` per optimizer step."""

from portbench.harness.readings import span_ms_per_step

SPANS = ("optimizer",)


def read(rec):
    return span_ms_per_step(rec, "optimizer")
