"""The training path's performance toggles, the counterpart of
``repro.perf.flags`` for one card.

  bf16_params   parameters held in bfloat16, with a float32 master copy in
                the optimizer state that the update applies to
                (``optim.adamw.init_opt_state(master_weights=True)``);
  pad_vocab     a vocab that is not a multiple of ``TP_DEGREE`` padded up
                to one (whisper: 51,865 -> 51,872), the pad columns masked
                to -1e30 (``ModelConfig.with_padded_vocab``), so the loss
                is unchanged.

Both are read by ``launch.steps.build_train_step`` and set by the
training driver's ``--flags`` (``launch.train``).  The reference's other
flags have no counterpart here: ``moe_tp_dispatch``,
``parallel_fused_ar``, ``serve_params_replicated``,
``serve_seq_sharded_kv`` and ``dense_pure_fsdp`` place work on a mesh,
and ``causal_skip`` is a schedule of the reference's jnp blockwise
attention; the port's flash kernels already skip the masked tiles in both
passes, so it would change no number.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    bf16_params: bool = False
    pad_vocab: bool = False


class _Box(threading.local):
    def __init__(self):
        self.flags = PerfFlags()


_BOX = _Box()


def get_flags() -> PerfFlags:
    return _BOX.flags


def set_flags(flags: PerfFlags) -> None:
    _BOX.flags = flags


@contextlib.contextmanager
def perf_flags(flags: PerfFlags):
    prev = get_flags()
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(prev)
