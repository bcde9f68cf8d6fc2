"""The port's kernel self-test (``lantern_tpu_torch/ops/selftest.py``)
against ``lantern_tpu/ops/pallas/selftest.py``.

- On the CPU, ``run_kernel_selftest(device="cpu")`` runs the plain versions
  and returns the keys the JAX module returns on the CPU, each error within
  its tolerance;
- the JAX module runs in interpret mode on the same ``default_rng(0)``
  numbers: its draws, recorded, equal ``draw_inputs``' in order;
- a failed check raises;
- marked ``cuda`` (skips here): on the card the kernels pass, with the
  deferred-against-rollback token check.
"""

import types

import numpy as np
import pytest
import torch

from lantern_tpu.ops.pallas import selftest as jst
from lantern_tpu_torch.ops import selftest as tst


@pytest.fixture(scope="module")
def jax_run():
    """The JAX self-test in interpret mode, with its random draws
    recorded."""
    draws = []

    class Recorder:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)

        def normal(self, size):
            draws.append(self.rng.normal(size=size))
            return draws[-1]

        def random(self, size):
            draws.append(self.rng.random(size))
            return draws[-1]

    proxy = types.ModuleType("numpy")
    proxy.__dict__.update(np.__dict__)
    proxy.random = types.SimpleNamespace(default_rng=Recorder)
    real = jst.np
    jst.np = proxy
    try:
        errs = jst.run_kernel_selftest()
    finally:
        jst.np = real
    return errs, draws


def test_selftest_on_cpu_has_the_jax_keys(jax_run):
    want, _ = jax_run
    got = tst.run_kernel_selftest(device="cpu")
    assert set(got) == set(want)
    assert got["backend"] == want["backend"] == "cpu"
    for k, v in got.items():
        if k != "backend":
            assert v <= tst.TOL[k], k
    # the block write and the rollback are exact on both
    assert got["kv_write"] == got["kv_rollback"] == 0.0


def test_same_inputs_as_the_jax_module(jax_run):
    _, draws = jax_run
    inp = tst.draw_inputs()
    order = ["q", "kn", "vn", "kc", "vc", "mask", "k_buf", "v_buf", "k_new",
             "v_new", "x", "w"]
    assert len(draws) == len(order)
    for name, d in zip(order, draws):
        if name == "mask":
            d = (d < 0.4) | np.eye(tst.T, dtype=bool)
        np.testing.assert_array_equal(inp[name], d.astype(inp[name].dtype),
                                      err_msg=name)


def test_selftest_raises_on_divergence(monkeypatch):
    """A check above its tolerance fails the self-test."""
    monkeypatch.setitem(tst.TOL, "tree_attention", 0.0)
    with pytest.raises(AssertionError, match="tree_attention"):
        tst.run_kernel_selftest(device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_selftest_on_the_card(cuda):
    errs = tst.run_kernel_selftest(device=cuda)
    assert errs["backend"] == "cuda"
    assert errs["deferred_flash_tokens"] == 0
    assert errs["int8_matmul_wide"] <= tst.TOL["int8_matmul_wide"]
