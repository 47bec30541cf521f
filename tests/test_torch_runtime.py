"""The port's runtime against the JAX runtime on identical plans.

Each graph is compiled ONCE, by the JAX package's compiler; the same plan
goes through ``repro.core.runtime.execute_plan`` and
``repro_torch.core.runtime.execute_plan`` with the same numpy-seeded
parameters and inputs, on CPU tensors (the kernels' plain versions), and
the outputs agree at the runtime's own 1e-4 contract.  The dense and
attention graphs are here; the convolutional ones are in
tests/test_torch_runtime_conv.py."""

import numpy as np
import pytest
import torch

from repro.core import runtime as jrt
from repro.core.api import compile_model
from repro.models import edge
from repro.models.lm_graphs import rwkv6_lm
from repro.soc.carfield import carfield_patterns, carfield_soc
from repro_torch.core import runtime as trt
from repro_torch.core.api import compile_model as t_compile_model
from repro_torch.core.api import compile_multi as t_compile_multi
from repro_torch.core.weights import params_from_jax
from repro_torch.models import edge as tedge
from repro_torch.soc.carfield import carfield_patterns as t_carfield_patterns
from repro_torch.soc.carfield import carfield_soc as t_carfield_soc

SOC = carfield_soc()
PATS = carfield_patterns()
TOL = dict(atol=1e-4, rtol=1e-4)

GRAPHS = {
    "autoencoder": edge.autoencoder,
    "transformer_block": edge.transformer_block,
    "rwkv6_lm": lambda: rwkv6_lm(seq=8, d=64, ffn=128),
}


def jax_vs_torch(g, plan):
    """Run ``plan`` through both runtimes on the same seeded values and
    hold the port to the JAX package at 1e-4."""
    jparams = jrt.init_params(g, 0)
    jinputs = jrt.init_inputs(g, 1)
    want = jrt.execute_plan(plan, jinputs, jparams)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              device="cpu")
    tinputs = params_from_jax({k: np.asarray(v) for k, v in jinputs.items()},
                              device="cpu")
    got = trt.execute_plan(plan, tinputs, tparams)
    assert set(got) == set(want)
    for t in g.outputs:
        assert tuple(got[t].shape) == tuple(want[t].shape)
        assert got[t].dtype == torch.float32
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   err_msg=f"{g.name}:{t}", **TOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_execute_plan_matches_jax(name):
    g = GRAPHS[name]()
    cm = compile_model(g, SOC, PATS, mode="matcha", time_budget_s=0.2)
    jax_vs_torch(g, cm.plan)


def test_params_from_jax_round_trips():
    g = edge.transformer_block()
    jparams = jrt.init_params(g, 3)
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = params_from_jax(arrays, device="cpu")
    own = trt.init_params(g, 3, device="cpu")
    assert set(tparams) == set(arrays) == set(own)
    for k, a in arrays.items():
        assert tparams[k].dtype == torch.float32
        assert np.array_equal(tparams[k].numpy(), a)
        assert torch.equal(tparams[k], own[k])   # same numpy streams
        tparams[k].add_(1.0)                     # owns its memory
        assert np.array_equal(np.asarray(jparams[k]), a)
    jin = jrt.init_inputs(g, 4)
    tin = trt.init_inputs(g, 4, device="cpu")
    for k in g.inputs:
        assert np.array_equal(tin[k].numpy(), np.asarray(jin[k]))


@pytest.fixture(scope="module")
def port_multi():
    graphs = [tedge.autoencoder(), tedge.transformer_block()]
    return t_compile_multi(graphs, t_carfield_soc(), t_carfield_patterns(),
                           time_budget_s=0.2, joint_time_budget_s=0.5,
                           lazy_joint_time_budget_s=0.2,
                           incremental_time_budget_s=0.2, max_hint_rounds=1)


def test_multi_plan_bitwise_equals_single(port_multi):
    """Interleaving tenants must not perturb numerics at all."""
    graphs = port_multi.graphs
    params = [trt.init_params(g, 2 * i, "cpu") for i, g in enumerate(graphs)]
    inputs = [trt.init_inputs(g, 2 * i + 1, "cpu")
              for i, g in enumerate(graphs)]
    multi = trt.execute_multi_plan(port_multi.plan, inputs, params)
    for i, g in enumerate(graphs):
        single = trt.execute_plan(port_multi.tenant_plan(i), inputs[i],
                                  params[i])
        for t in g.outputs:
            assert torch.equal(single[t], multi[i][t]), (g.name, t)
    assert trt.multi_plan_matches_oracle(port_multi.plan, device="cpu")


@pytest.mark.parametrize("name", ["autoencoder", "transformer_block"])
def test_port_compiler_passes_oracle(name):
    """The port's own copy of the compiler yields plans the port's runtime
    executes correctly.  Its CP is time-budgeted, so its plans are not
    asserted equal to the JAX package's."""
    cm = t_compile_model(tedge.ALL_MODELS[name](), t_carfield_soc(),
                         t_carfield_patterns(), mode="matcha",
                         time_budget_s=0.2)
    assert trt.plan_matches_oracle(cm.plan, device="cpu")
    inputs = trt.init_inputs(cm.graph, 1, "cpu")
    params = trt.init_params(cm.graph, 0, "cpu")
    out = cm.run(inputs, params)          # deploy.py's seam -> port runtime
    want = trt.execute_graph(cm.graph, inputs, params)
    for t in cm.graph.outputs:
        np.testing.assert_allclose(out[t].numpy(), want[t].numpy(), **TOL)
