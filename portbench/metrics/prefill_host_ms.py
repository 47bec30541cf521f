"""prefill_host_ms: the median host ms from a request's send to the
return of its ``prefill`` call, before the wait for its token: the
host's enqueue cost of a prefill."""

from portbench.harness.readings import host_ms_median as read  # noqa: F401
