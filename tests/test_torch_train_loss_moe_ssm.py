"""The zoo's training step on the CPU against the JAX reference, at the
float32 smoke configs of
phi3p5_moe_42b, qwen3_moe_30b, falcon_mamba_7b and zamba2_2p7b:
the port's ``lm_loss`` (loss, ntok, moe_aux, moe_z), its gradients through
``backward()`` (every leaf, and ``grad_norm``) and one AdamW update of
``launch.steps.build_train_step`` (the moments and the parameters), from
the reference's numpy parameters and batch with a loss mask, against
``jax.value_and_grad(repro.models.lm_loss)`` and
``repro.optim.adamw_update``.  Tolerances and their measured maxima:
``tests/torch_train_cases.py``.  The ten configs are split over three
files so that the workers share them."""
import pytest

import torch_train_cases as C

CASES = {arch: dict(arch=arch, loss_mask=True)
         for arch in ("phi3p5_moe_42b", "qwen3_moe_30b",
                      "falcon_mamba_7b", "zamba2_2p7b")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_metrics(case):
    C.check_loss(**CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_and_grad_norm(case):
    C.check_grads(**CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_adamw_update(case):
    C.check_update(**CASES[case])
