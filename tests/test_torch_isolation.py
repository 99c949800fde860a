"""The port stands alone: with `jax` and `repro` made unimportable, the
whole `repro_torch` package imports and routes a batch on the CPU."""

import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import pkgutil
import numpy as np
import torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
from repro_torch.api import RouteSpec, build
from repro_torch.retrieval import scorer as sc
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
rng = np.random.default_rng(0)
scores = -np.sort(-rng.uniform(0.01, 1, (16, 100)).astype(np.float32), 1)
for backend in ("oracle", "pallas", "fused", "auto"):
    session = build(RouteSpec(thresholds=(-0.3,), backend=backend),
                    device="cpu")
    tiers = session.route(scores).tiers
    assert tiers.shape == (16,)
cfg = sc.ScorerConfig(d_hidden=16)
params = sc.init_scorer(torch.Generator().manual_seed(0), cfg, device="cpu")
feats = rng.normal(0, 1, (4, 40, cfg.d_triple)).astype(np.float32)
qemb = rng.normal(0, 1, (4, cfg.d_query)).astype(np.float32)
res = build(RouteSpec(thresholds=(-0.3,), backend="fused"),
            device="cpu").route_retrieved(feats, qemb, params)
assert res.tiers.shape == (4,)
print("ok", len(names))
"""


def test_port_imports_and_routes_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
