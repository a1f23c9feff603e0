"""The zoo's training step on the CPU against the JAX reference, at the
float32 smoke configs of
deepseek_7b, yi_6b, phi3_medium_14b and command_r_plus_104b:
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
         for arch in ("deepseek_7b", "yi_6b",
                      "phi3_medium_14b", "command_r_plus_104b")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_metrics(case):
    C.check_loss(**CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_and_grad_norm(case):
    C.check_grads(**CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_adamw_update(case):
    C.check_update(**CASES[case])


def test_bf16_params_train_with_a_float32_master():
    """``PerfFlags(bf16_params=True)``: the step trains parameters held in
    bfloat16 (``param_dtype``) with the optimizer's float32 master, as the
    reference's ``build_train_step`` does.  Against the reference's
    value_and_grad and master-weight update from the same bfloat16
    parameters: the loss within LOSS_TOL, grad_norm within 2**-7 (the
    gradients are bfloat16 on both sides, rounded at other points), the
    master within the first update's bound 2 lr of the reference's, and
    the parameters the master's bfloat16 casts."""
    import dataclasses

    import jax
    import numpy as np
    import torch

    from repro import models as R
    from repro import optim as RO
    from repro_torch import tree as T
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.perf import PerfFlags, perf_flags

    cfg = C.config("yi_6b")
    cfg_b = dataclasses.replace(cfg, param_dtype="bfloat16")
    b = C.batch(cfg, 1, loss_mask=False)
    params = R.init_params(cfg_b, jax.random.PRNGKey(1))

    @jax.jit
    def ref_step(params, batch):
        (loss, _), grads = jax.value_and_grad(R.lm_loss, has_aux=True)(
            params, batch, cfg_b)
        return (loss,) + RO.adamw_update(
            params, grads, RO.init_opt_state(params, master_weights=True),
            RO.OptConfig(**C.OPT))

    loss, _, opt, om = ref_step(params, b)
    with perf_flags(PerfFlags(bf16_params=True)):
        step = build_train_step(cfg, OptConfig(**C.OPT), device="cpu")
    assert step.cfg.param_dtype == "bfloat16"
    held = dataclasses.replace(step.cfg, dtype=step.cfg.param_dtype)
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    port = params_from_numpy(held, p_np, device="cpu")
    state = init_opt_state(port, master_weights=True)
    new, state, metrics = step(port, state, b)
    assert abs(float(metrics["loss"]) - float(loss)) <= \
        C.LOSS_TOL * float(loss)
    assert abs(float(metrics["grad_norm"]) - float(om["grad_norm"])) <= \
        2 ** -7 * float(om["grad_norm"])
    want = params_from_numpy(
        dataclasses.replace(held, param_dtype="float32", dtype="float32"),
        jax.tree.map(np.asarray, opt["master"]), device="cpu")
    new_l, paths = T.flatten(new)
    for path, p, m, w in zip(paths, new_l, T.leaves_at(state["master"], paths),
                             T.leaves_at(want, paths)):
        assert m.dtype == torch.float32
        assert p.dtype == (torch.float32 if path[-1] == "router"
                           else torch.bfloat16), path
        assert torch.equal(p, m.to(p.dtype)), path
        assert float((m - w).abs().max()) <= 2 * C.OPT["lr"], path
