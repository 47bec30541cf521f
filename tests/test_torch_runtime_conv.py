"""The port's runtime against the JAX runtime on identical plans of the
convolutional MLPerf-Tiny graphs: NHWC/HWIO layouts, asymmetric ``same``
padding, depthwise weights, pooling and conv row tiles with halos.  Same
method as tests/test_torch_runtime.py."""

import pytest

from repro.core.api import compile_model
from repro.models import edge
from repro.soc.carfield import carfield_patterns, carfield_soc
from test_torch_runtime import jax_vs_torch

SOC = carfield_soc()
PATS = carfield_patterns()


@pytest.mark.parametrize("name", ["ds_cnn", "mobilenet", "resnet"])
def test_execute_plan_matches_jax(name):
    g = edge.ALL_MODELS[name]()
    cm = compile_model(g, SOC, PATS, mode="matcha", time_budget_s=0.2)
    jax_vs_torch(g, cm.plan)
