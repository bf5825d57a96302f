"""The port's training gradients and train step against the JAX package,
for four of the ten reduced architectures (the other six:
tests/test_torch_train_grads_a.py; the shared code:
tests/test_torch_train_parity.py).

Per architecture, from the JAX parameters and one numpy batch (fp32):
the loss within a scaled 1e-5 and every gradient leaf, mapped by key
path, within a scaled 1e-4 of ``jax.value_and_grad(lm.loss_fn)``; one
adamw ``make_train_step`` and its two-microbatch form against the
reference's; two microbatches against one; remat ("full" and "dots")
changing no gradient beyond 1e-6 scaled.
"""

import pytest
import torch

import test_torch_train_parity as par

torch.set_num_threads(1)

ARCHS = ["llama32_vision_90b", "xlstm_125m", "llama4_maverick",
         "dbrx_132b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    par.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    par.check_train_step(arch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_jax_and_one_batch(arch):
    par.check_microbatches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch):
    par.check_remat(arch)
