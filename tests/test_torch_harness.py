"""Parity harness of the PyTorch port (``repro_torch``).

* ``params_from_jax`` carries every leaf of a JAX parameter tree across
  bit for bit, and the port's own ``init_params`` builds the same tree
  layout and shapes;
* the port never imports JAX or the JAX package (checked in a fresh
  interpreter through ``sys.modules``);
* device resolution defaults to the card and takes the CPU only when
  asked; kernel wrappers given CPU tensors run their plain versions and
  count no launch.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.tgn_gdelt import gat, graphsage, tgat, tgn
from repro.models import gnn as G
from repro_torch.configs import tgn_gdelt as TC
from repro_torch.device import resolve
from repro_torch.kernels import runtime
from repro_torch.models import gnn as TG
from repro_torch.models.convert import params_from_jax

SMALL = dict(d_node=6, d_edge=5, d_time=4, d_hidden=8, d_memory=6)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("make", [tgat, tgn, graphsage, gat])
def test_params_from_jax_round_trips_every_leaf(make):
    cfg = make(**SMALL)
    jtree = jax.tree.map(np.asarray, G.init_params(cfg, jax.random.PRNGKey(0)))
    ttree = params_from_jax(jtree, device="cpu")
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        t = tl[path]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)
    # a private copy: writing the port's tensor leaves the JAX side alone
    path0, a0 = next(iter(jl.items()))
    before = a0.copy()
    tl[path0].add_(1.0)
    np.testing.assert_array_equal(a0, before)
    # the port's own initialiser builds the same layout and shapes
    tcfg = getattr(TC, make.__name__)(**SMALL)
    own = dict(_leaves(TG.init_params(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")))
    assert own.keys() == jl.keys()
    for path, a in jl.items():
        assert tuple(own[path].shape) == a.shape, path


def test_port_imports_neither_jax_nor_repro(subprocess_env):
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'repro') or\n"
        "             n.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "n = sum(1 for n in sys.modules if n.startswith('repro_torch.'))\n"
        "print('modules', n)\n")
    out = subprocess.run([sys.executable, "-c", code], env=subprocess_env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25


def test_device_defaults_to_the_card():
    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve()
        with pytest.raises(RuntimeError):
            resolve("cuda")


def test_cpu_tensors_take_the_plain_versions_without_launching():
    from repro_torch.kernels.cache_gather.ops import cache_gather
    from repro_torch.kernels.temporal_attn.ops import temporal_attn
    runtime.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 2, 4, generator=g)
    k = torch.randn(3, 5, 2, 4, generator=g)
    temporal_attn(q, k, k, torch.ones(3, 5, dtype=torch.bool))
    cache_gather(torch.full((10,), -1, dtype=torch.int32),
                 torch.full((4,), -1, dtype=torch.int32),
                 torch.zeros(4, 3), torch.arange(5, dtype=torch.int32))
    assert runtime.launch_counts() == {}
