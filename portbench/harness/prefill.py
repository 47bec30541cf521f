"""The serving driver: long prompts through the port's ``prefill``, a
closed loop of one client, for ``--seconds``.

Each request is sent when the one before it has its first token: its
token ids are copied to the card, ``get_model(cfg).prefill`` runs over
them with a cache of the prompt plus ``cache_extra`` positions, and the
served token, the argmax of the last position's logits, is read back on
the host.  ``ttft_p95_ms`` is the 95th percentile of send-to-token over
every request of the window; ``prefill_tokens_per_s`` every prompt token
served in the window over its seconds.  Set-up makes the weights and
serves every prompt length of the mix once, the longest first.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import cell as C
from portbench.harness import checks, traffic
from portbench.harness.trace import Trace


def p95(xs) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell, cfg, seed: int, seconds: float, device, t_start: float,
        spans=None, trace: bool = False) -> C.Run:
    from repro_torch.models.api import get_model

    mix, config = cell.mix, cell.config
    if mix.get("clients", 1) != 1:
        raise SystemExit("the prefill driver runs one client")
    parts = {"to_driver_s": time.perf_counter() - t_start}
    model = get_model(cfg)
    params = C.make_params(config, cfg, seed, device)
    prompts = traffic.Prompts(mix, cfg.vocab, seed)
    extra = mix["cache_extra"]
    pin = device.type == "cuda"
    buf = torch.empty((1, max(prompts.lengths)), dtype=torch.int64)
    if pin:
        buf = buf.pin_memory()

    def serve(ids: np.ndarray):
        # one request at a time: the last copy out of ``buf`` has ended
        x = buf[:, :ids.shape[1]]
        x.copy_(torch.from_numpy(ids))
        x = x.to(device, non_blocking=True)
        logits, cache = model.prefill(cfg, params, x, x.shape[1] + extra)
        return logits, cache, logits.argmax(-1)

    with torch.no_grad():
        if pin:
            torch.cuda.synchronize(device)
        parts["weights_s"] = time.perf_counter() - t_start \
            - sum(parts.values())
        rng = np.random.default_rng([int(seed), 1 << 43])
        for n in sorted(set(prompts.lengths), reverse=True):
            serve(rng.integers(0, cfg.vocab, size=(1, n),
                               dtype=np.int64))[2].item()
        parts["warm_up_s"] = time.perf_counter() - t_start \
            - sum(parts.values())
        if spans:
            spans.clear()

        cached = checks.cache_sample(mix, seed, prompts)
        ttft, host, lengths, tokens, logits_kept, caches = \
            [], [], [], [], [], {}
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        i = 0
        while True:
            sent = time.perf_counter()
            logits, cache, tok = serve(prompts.ids(i))
            returned = time.perf_counter()
            tokens.append(int(tok.item()))
            done = time.perf_counter()
            ttft.append(done - sent)
            host.append(returned - sent)
            lengths.append(prompts.length(i))
            logits_kept.append(logits[0])
            if i in cached:
                caches[i] = cache
            del logits, cache
            i += 1
            if done - t0 >= seconds:
                break
        window_s = done - t0
        record = SimpleNamespace(
            config=config, mix=mix, window_s=window_s, lengths=lengths,
            host_ms=[h * 1e3 for h in host],
            spans=spans.summary() if spans else {}, trace=None)
        if trace:
            # a whole cycle of the mix's prompt lengths under the profiler,
            # after one request for its start-up
            k = (i // len(prompts.lengths) + 1) * len(prompts.lengths)
            with Trace(device) as tr:
                for r in range(k - 1, k + len(prompts.lengths)):
                    if r == k:
                        tr.begin()
                    serve(prompts.ids(r))[2].item()
            record.trace = tr.reduce()

    device_info = C.device_info(device, cell.chips)
    finite = torch.isfinite(torch.stack(logits_kept)).all(-1)
    failed = int((~finite).sum())

    # the served tokens and outputs of the sample; the rest goes first
    served = {}
    for r in checks.logits_sample(mix, seed, len(lengths), cached):
        kvs = None
        if r in caches:
            c = caches[r]["slots"][0]
            S = lengths[r]
            kvs = [(c["k"][g, 0, :S], c["v"][g, 0, :S])
                   for g in range(c["k"].shape[0])]
        served[r] = (tokens[r], logits_kept[r], kvs)
    del params, caches, logits_kept
    gc.collect()
    if pin:
        torch.cuda.empty_cache()
    numbers = checks.reference_serve(config, mix, seed, device, served)
    ok, table = checks.verdict(numbers, cell.limits)
    return C.Run(correct=ok and failed == 0, attempted=len(lengths),
                 failed=failed,
                 end_to_end={"prefill_tokens_per_s": sum(lengths) / window_s,
                             "ttft_p95_ms": p95(ttft) * 1e3,
                             "setup_s": setup_s},
                 record=record, device=device_info, checks=table,
                 trace=record.trace, setup_parts=parts)

