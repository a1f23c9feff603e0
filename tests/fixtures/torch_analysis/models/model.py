# Planted REX001 and REX002 corpus: the zoo's decode step syncs, its init
# draws from the default generator.
# rex-expect: REX001=3
# rex-expect: REX002=1
import torch


def _tokens(tokens, dev):
    return torch.as_tensor(tokens, device=dev)       # planted: host tokens


def init_params(shape):
    w = torch.randn(shape)                           # planted: REX002
    return {"w": w, "norm": w.norm().item()}         # init is not hot: fine


def forward(params, x):
    return x @ params["w"]


def decode_step(params, state, token, dev):
    tok = _tokens(token, dev)                        # planted: via a helper
    logits = forward(params, params["w"][tok])
    pos = state["pos"].cpu()                         # planted: .cpu()
    return logits, dict(state, pos=pos + 1)
