"""The port's serving engine against the JAX package's on the trace of
``launch/serve.py``.

The CP behind every compile is time-budgeted, so two compiles of the same
request may ship different plans (and makespans).  Both engines are
therefore driven in lockstep over ONE compiled session — the one the JAX
``build_engine`` compiles — so each sees the same plan store at every
round: the first engine to meet an occupancy compiles it into the shared
store, the other hits it.  (Each package's background compiler only takes
its own package's plan keys, so the lockstep engines compile on demand.)
What differs is the engine (the port's copy) and the runtime (the
port's, on CPU tensors): their reports must be equal and every result
must agree by request id at the runtime's 1e-4.  The port's own
``build_engine``, with its background compiler, is driven separately and
held to whole-graph evaluation in both runtimes."""

import random

import numpy as np
import pytest

from repro.core import runtime as jrt
from repro.launch.serve import build_engine as jax_build_engine
from repro.serve.engine import MultiModelEngine as JaxEngine
from repro_torch.core import runtime as trt
from repro_torch.launch.serve import build_engine as port_build_engine
from repro_torch.serve.engine import MultiModelEngine as PortEngine

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 16


def drive(engines, compiler=None, n_prompts=2, decode_steps=2, seed=0):
    """launch/serve.py's trace — a prefill at a random length, then decode
    steps, the vision tenant riding along — submitted to every engine in
    turn, with one background-compiler pump per step when there is one."""
    rng = random.Random(seed)
    for _ in range(n_prompts):
        steps = [rng.randint(2, MAX_SEQ)] + [1] * decode_steps
        for seq_len in steps:
            for eng in engines:
                eng.submit(1, seq_len=seq_len)
                eng.submit(0)
            if compiler is not None:
                compiler.run_pending()
            for eng in engines:
                eng.step()
    for eng in engines:
        eng.run()


@pytest.fixture(scope="module")
def lockstep():
    built, _ = jax_build_engine("rwkv6", max_seq=MAX_SEQ, d=64, ffn=128)
    jeng = JaxEngine(built.compiled, execute=True)
    peng = PortEngine(built.compiled, execute=True, device="cpu")
    drive([jeng, peng])
    return jeng, peng


def test_reports_equal(lockstep):
    jeng, peng = lockstep
    jrep, prep = jeng.report(), peng.report()
    assert jrep["served"] == 2 * (1 + 2) * 2
    assert prep == jrep


def test_results_match_by_rid(lockstep):
    jeng, peng = lockstep
    assert sorted(jeng.results) == sorted(peng.results)
    for rid, want in jeng.results.items():
        got = peng.results[rid]
        assert set(got) == set(want)
        for t, v in want.items():
            np.testing.assert_allclose(got[t].numpy(), np.asarray(v),
                                       err_msg=f"rid {rid} {t}", **TOL)


def test_port_params_equal_jax(lockstep):
    jeng, peng = lockstep
    for jp, tp in zip(jeng.params, peng.params):
        assert set(jp) == set(tp)
        for k in jp:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_port_build_engine_serves_oracle_results():
    eng, compiler = port_build_engine("rwkv6", max_seq=MAX_SEQ, d=64,
                                      ffn=128, prefetch=False, execute=True,
                                      device="cpu")
    drive([eng], compiler, n_prompts=1)
    rep = eng.report()
    assert rep["served"] == len(eng.results) == 2 * (1 + 2)
    for rid, out in eng.results.items():
        req = eng.done[rid]
        g = (eng.session.bucket_graph(req.tenant, req.bucket)
             if req.bucket is not None else eng.compiled.graphs[req.tenant])
        want = trt.execute_graph(g, req.inputs, eng.params[req.tenant])
        jwant = jrt.execute_graph(
            g, {k: v.numpy() for k, v in req.inputs.items()},
            {k: v.numpy() for k, v in eng.params[req.tenant].items()})
        for t in g.outputs:
            np.testing.assert_allclose(out[t].numpy(), want[t].numpy(),
                                       **TOL)
            np.testing.assert_allclose(out[t].numpy(), np.asarray(jwant[t]),
                                       **TOL)
